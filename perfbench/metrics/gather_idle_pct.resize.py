"""The traced window's idle seconds under the program's
``pipelines.resize.gather`` span, over the window, in %."""

from perfbench import spans


def read(run):
    return spans.idle_pct(run, "pipelines.resize.gather")
