"""Seconds from the process's start to the first unit of the window."""


def read(run):
    return run.setup_s
