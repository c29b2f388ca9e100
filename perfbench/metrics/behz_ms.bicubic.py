"""Device ms per image of the non-NTT kernels that BEHZ launched: those
under the program's ``bfv.evaluator.multiply`` span and its ``bfv.rns.*``
children, in the bicubic spans' traced window."""

from perfbench import bicubic_spans


def read(run):
    return bicubic_spans.behz_ms(run)
