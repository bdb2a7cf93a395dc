"""BAD: float accumulation over unordered iterables in checksum/verify
paths -> SC605. Addition is not associative in floats: the readdir/hash
iteration order changes the accumulated bits, and a replay gate then
compares those bits.
"""
import os


def verify_checksum(directory, expected):
    total = sum(float(name.split("-")[-1])
                for name in os.listdir(directory))
    return total == expected


def replay_digest(parts):
    shards = set(parts)
    acc = 0.0
    for shard in shards:
        acc += float(shard)
    return acc
