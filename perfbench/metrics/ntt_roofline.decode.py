"""The NTT launches' least time (each residue read and written once, or
their fewest operations) over the NTT kernels' device time in the decode
spans' traced window, in %."""

from perfbench import decode_spans


def read(run):
    return decode_spans.ntt_roofline(run)
