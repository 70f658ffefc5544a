"""The sampler kernels' share of their roofline: the bounds of the gather
(K5), its coordinate gradient (K5b) and the splat (K6) where a step
differentiates it, with the image cells the in-range taps touch as the
plain reference's calls count them, over those kernels' device time in the
trace, %. A tracking frame runs the gather alone: in deformable attention,
DCNv2 and the BEV shift."""

from gpubench.readers import roofline_pct


def read(r):
    return roofline_pct(r, ("K5", "K5b", "K6"))
