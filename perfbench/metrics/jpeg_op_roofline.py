"""The JPEG op's least time (its chunk read and written once, or its
fewest integer operations) over its device time, in %."""

from perfbench import readers


def read(run):
    return readers.step_roofline(run)
