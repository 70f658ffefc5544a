"""Reduce a ``torch.profiler`` trace of a few steps or frames to what the
per-layer readers and the result's ``breakdown`` take: device time by
kernel group and by kernel name, launches, the device's busy time, the top
device operations and the idle gaps labelled by the host operation open
during them.

The kernel-name table is a copy of the port's
``sndepth_tpu_torch/utils/profiling.GROUPS``, frozen here so that a change
to the port cannot move the yardstick, with cuDNN's FFT kernels added to
the convolutions.
"""

from __future__ import annotations

import bisect

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
    # cuDNN's FFT algorithms (float32 without TF32) run as "fft" and
    # "region_transform" kernels: convolutions too.
    ("convolutions", ("gemm", "conv", "cutlass", "cudnn", "xmma", "wgrad",
                      "dgrad", "implicit", "winograd", "fft",
                      "region_transform")),
    ("reductions", ("reduce",)),
    ("gather/scatter/index", ("index", "gather", "scatter")),
    ("elementwise and copies", ("elementwise", "vectorized", "copy", "cat",
                                "unrolled", "fill", "memcpy", "memset")),
)

TOP = 10


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _device_events(events):
    import torch
    out = []
    for evt in events:
        # Device-side events only, without the device-side mirror of a host
        # annotation, whose time is that of the kernels inside it.
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or "#" in evt.name or evt.name.startswith("ProfilerStep")
                or evt.name.startswith("gpubench.")):
            continue
        out.append(evt)
    return out


def _host_events(events):
    import torch
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _label(host, starts, t: float) -> str:
    """The innermost host operation open at ``t`` (microseconds): of those
    that started by ``t`` and end after it, the one that started last.
    ``host`` is sorted by start, ``starts`` its starts."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if host[i].time_range.end >= t:
            return host[i].name
        i -= 1
    return "host idle"


def reduce(events, units: int, window_s: float) -> dict:
    """``events``: a profile's ``events()`` over ``units`` steps or frames
    that took ``window_s`` on the host clock, synchronised at both ends."""
    dev = _device_events(events)
    by_group: dict[str, float] = {}
    by_name: dict[str, float] = {}
    intervals = []
    for e in dev:
        tr = e.time_range
        us = tr.end - tr.start
        by_group[group_of(e.name)] = by_group.get(group_of(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        intervals.append((tr.start, tr.end))
    merged = _merge(intervals)
    busy_us = sum(end - start for start, end in merged)
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1])
            for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    host = sorted(_host_events(events), key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    idle_by_label: dict[str, float] = {}
    for length, start in gaps:
        label = _label(host, starts, start + length / 2)
        idle_by_label[label] = idle_by_label.get(label, 0.0) + length
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(idle_by_label.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "units": units,
        "window_s": window_s,
        "busy_s": busy_us * 1e-6,
        "launches": len(dev),
        "group_s": {g: us * 1e-6 for g, us in by_group.items()},
        "op_s": {name: us * 1e-6 for name, us in by_name.items()},
        "device_ops": [[name[:120], us * 1e-6] for name, us in top_ops],
        "idle_gaps": [[name[:120], us * 1e-6] for name, us in top_gaps],
    }


def profiled(run_units, units: int, device):
    """Run ``run_units(units)`` under ``torch.profiler`` with the card's
    activity; returns the reduced trace."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_units(units)
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    return reduce(prof.events(), units, window_s)
