"""Device ms per image of the non-NTT kernels that BEHZ launched: those
under the program's ``bfv.evaluator.multiply`` span and its ``bfv.rns.*``
children."""

from perfbench import spans


def read(run):
    return spans.behz_ms(run)
