"""A resize's least time (its source and fract ciphertexts read and its
output written once) over its device time, in %."""

from perfbench import readers


def read(run):
    return readers.step_roofline(run)
