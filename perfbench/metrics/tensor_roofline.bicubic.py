"""BEHZ's tensor step's least time (4 bytes in each of the L + K primes for
every operand position read and product position written, from
``rns.multiply``'s counters) over the non-NTT device time under the
program's ``bfv.rns.tensor`` span, in %."""

from perfbench import bicubic_spans


def read(run):
    return bicubic_spans.tensor_roofline(run)
