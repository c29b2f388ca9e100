"""The NTT launches' least time (each residue read and written once, or
their fewest operations) over the NTT kernels' device time in the traced
window, in %."""

from perfbench import spans


def read(run):
    return spans.ntt_roofline(run)
