"""Channel-blocks (one 8x8 block of one colour channel) completed per second."""

from perfbench import readers


def read(run):
    return readers.rate(run, "channel_blocks")
