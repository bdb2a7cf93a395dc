"""GOOD: checksum/replay accumulation runs over SORTED iterables -> no
SC605. With the iteration order pinned, float addition produces the same
bits on every host and every replay.
"""
import os


def verify_checksum(directory, expected):
    total = sum(float(name.split("-")[-1])
                for name in sorted(os.listdir(directory)))
    return total == expected


def replay_digest(parts):
    acc = 0.0
    for shard in sorted(set(parts)):
        acc += float(shard)
    return acc
