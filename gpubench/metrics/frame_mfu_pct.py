"""The plain reference's convolution and matrix FLOPs of one frame
(FlopCounterMode) over the window's mean frame time, against 67 TFLOP/s,
an H100's float32 peak outside the tensor cores (the configuration runs
float32 with TF32 off), %."""

from gpubench.readers import mfu_pct as read  # noqa: F401
