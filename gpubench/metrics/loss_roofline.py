"""The loss kernels' share of their roofline: the bounds of the photo
kernel (K1, K3, K4), the smoothness sums (K2) and the DSSIM map and its
adjoint (K7), as the plain reference's calls count them, over those
kernels' device time in the trace, %."""

from gpubench.readers import roofline_pct


def read(r):
    return roofline_pct(r, ("K1", "K3", "K4", "K2", "K7"))
