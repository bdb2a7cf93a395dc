"""BAD: checkpoint files are collected in listdir order into a list that
is never sorted -> SC603."""
import os


def checkpoint_steps(directory):
    steps = []
    for name in os.listdir(directory):
        if name.startswith("ckpt-"):
            steps.append(int(name[5:]))
    return steps
