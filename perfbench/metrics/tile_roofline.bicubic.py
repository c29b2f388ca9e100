"""A bicubic resize's least time (each tile's source and fract ciphertexts
read and the image's size-8 outputs written once) over its device time, in %."""

from perfbench import readers


def read(run):
    return readers.step_roofline(run)
