"""Device ms a train step of the convolution group (cuDNN and GEMM
kernels of DispNetS, PoseNet and FlowNet), from the trace."""

from gpubench.readers import group_ms_per_unit


def read(r):
    return group_ms_per_unit(r, "convolutions")
