"""Device ms a frame of the convolution group (the ResNet-101 with DCN
and the FPN through cuDNN, and the GEMMs), from the trace."""

from gpubench.readers import group_ms_per_unit


def read(r):
    return group_ms_per_unit(r, "convolutions")
