"""Device ms per image under the program's ``pipelines.resize.cubic_interp``
span less that under its ``bfv.evaluator.multiply`` spans: the products by
encoded constants with their NTT bounces, and the adds."""

from perfbench import bicubic_spans


def read(run):
    return bicubic_spans.stencil_ms(run)
