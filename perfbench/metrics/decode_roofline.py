"""A decode's least time (the weight tables and the image's harmonics read
and its three channels' outputs written once) over its device time, in %."""

from perfbench import readers


def read(run):
    return readers.step_roofline(run)
