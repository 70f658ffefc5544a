"""Device time of the kernels that a ``torch.profiler`` run recorded,
summed by kernel group and by name, as ``cli/profile_step.py`` and the
training loop's profiled step report it."""

from __future__ import annotations

# First match wins; the hand-written kernels come first.
GROUPS = (
    ("K1/K3/K4 photo_pair", ("photo_pair_kernel",)),
    ("K2 smooth", ("smooth_kernel",)),
    ("K5 warp_gather", ("warp_gather_kernel",)),
    ("K5b warp_coord_grad", ("warp_coord_grad_kernel",)),
    ("K6 warp_splat", ("warp_splat",)),
    ("K7 dssim", ("dssim_fwd_kernel", "dssim_bwd_kernel")),
    ("K8 gn_build", ("gn_build_kernel",)),
    ("K8b gn_build_bwd", ("gn_bwd_kernel",)),
    ("layout transposes", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("adam", ("multi_tensor", "adam", "foreach")),
    ("convolutions", ("gemm", "conv", "cutlass", "cudnn", "xmma", "wgrad",
                      "dgrad", "implicit", "winograd")),
    ("reductions", ("reduce",)),
    ("gather/scatter/index", ("index", "gather", "scatter")),
    ("elementwise and copies", ("elementwise", "vectorized", "copy", "cat",
                                "unrolled", "fill", "memcpy", "memset")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def device_kernels(prof, steps: int = 1) -> tuple[dict, dict, int]:
    """The kernels a ``torch.profiler`` run recorded on the card: ms a step
    by group, [ms a step, launches] by name, and the launch count."""
    import torch
    by_group: dict[str, float] = {}
    by_name: dict[str, list] = {}
    launches = 0
    for evt in prof.events():
        # Device-side events only, without the device-side mirror of a
        # host annotation (such as the optimizer's step scope), whose time
        # is that of the kernels inside it.
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or "#" in evt.name or evt.name.startswith("ProfilerStep")):
            continue
        us = getattr(evt, "device_time", None)
        if us is None:
            us = evt.cuda_time
        ms = us * 1e-3 / steps
        launches += 1
        by_group[group_of(evt.name)] = by_group.get(group_of(evt.name), 0) + ms
        entry = by_name.setdefault(evt.name, [0.0, 0])
        entry[0] += ms
        entry[1] += 1
    return by_group, by_name, launches
