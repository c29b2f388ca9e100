"""Encrypted-fract bilinear resizes completed per second."""

from perfbench import readers


def read(run):
    return readers.rate(run, "images")
