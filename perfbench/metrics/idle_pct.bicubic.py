"""The share of the traced window in which no operation ran on the card, in %."""

from perfbench import readers


def read(run):
    return readers.idle_pct(run)
