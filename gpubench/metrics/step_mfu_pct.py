"""The plain reference's convolution and matrix FLOPs of one train step
(FlopCounterMode, forward and backward) over the window's mean step time,
against 989 TFLOP/s, an H100's dense bf16 peak, %."""

from gpubench.readers import mfu_pct as read  # noqa: F401
