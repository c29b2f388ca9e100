"""Device ms per channel of the kernels launched under the program's
``pipelines.rle_decode.expand`` span, over its ``calls`` counter."""

from perfbench import decode_spans


def read(run):
    return decode_spans.expand_ms(run)
