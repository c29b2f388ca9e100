"""The NTT launches' least time (each residue read and written once, or
their fewest operations) over the NTT kernels' device time in the bicubic
spans' traced window, in %."""

from perfbench import bicubic_spans


def read(run):
    return bicubic_spans.ntt_roofline(run)
