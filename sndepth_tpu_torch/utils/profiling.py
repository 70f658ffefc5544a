"""What a ``torch.profiler`` run recorded on the card: the kernels' device
time summed by kernel group and by name, as ``cli/profile_step.py`` and the
training loop's profiled step report it; the device's busy time; and, by
the program's spans (``utils/tracing.SPANS``), the kernels each launched
and the idle gaps each held."""

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

NO_SPAN = "(no span)"


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def is_device_op(name: str) -> bool:
    """Whether a device event of this name is an operation of its own: the
    device-side mirror of a host annotation (such as the optimizer's step
    scope, or a span of ``utils/tracing``, whose names hold ``#``) spans
    the kernels inside it and is not."""
    return "#" not in name and not name.startswith("ProfilerStep")


def device_events(events) -> list:
    """The device operations among a profile's ``events()``."""
    import torch
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and is_device_op(e.name)]


def device_kernels(prof, steps: int = 1) -> tuple[dict, dict, int]:
    """The kernels a ``torch.profiler`` run recorded on the card: ms a step
    by group, [ms a step, launches] by name, and the launch count."""
    by_group: dict[str, float] = {}
    by_name: dict[str, list] = {}
    launches = 0
    for evt in device_events(prof.events()):
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


def _merged(events) -> list:
    """The device operations' intervals (us), overlaps merged."""
    merged = []
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in device_events(events)):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def busy_ms(events) -> float:
    """The device's busy time: the union of its operations' intervals."""
    return sum(end - start for start, end in _merged(events)) * 1e-3


def _host(events) -> tuple[list, list]:
    """The host events, sorted by start: (program spans, other events)."""
    import torch

    from sndepth_tpu_torch.utils.tracing import SPANS
    host = sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.time_range.start)
    return ([e for e in host if e.name in SPANS],
            [e for e in host if e.name not in SPANS])


def _open_at(host: list, starts: list, t: float):
    """The innermost of ``host`` (sorted by start) open at ``t``: of those
    that started by ``t`` and end after it, the one that started last."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if host[i].time_range.end >= t:
            return host[i]
        i -= 1
    return None


def by_span(events, steps: int = 1) -> dict:
    """{span: {"ms", "launches", "groups"}} a step: the device operations
    that each program span launched, with their ms by kernel group. A
    device operation shares its correlation id with the runtime call that
    launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``); its span is the
    innermost one open at that call, on any thread (autograd's device
    thread runs the backward inside the step's ``geonet#backward``). A
    hand-written kernel is launched from Python through ctypes, so the op
    that the profiler links it to is an ancestor of its ``kernel#`` span,
    not the span."""
    import torch
    spans, _ = _host(events)
    starts = [e.time_range.start for e in spans]
    calls = {e.id: e for e in events
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.name.startswith("cu")}
    out: dict[str, dict] = {}
    for evt in device_events(events):
        call = calls.get(evt.id)
        owner = (None if call is None
                 else _open_at(spans, starts, call.time_range.start))
        entry = out.setdefault(NO_SPAN if owner is None else owner.name,
                               {"ms": 0.0, "launches": 0, "groups": {}})
        ms = (evt.time_range.end - evt.time_range.start) * 1e-3 / steps
        entry["ms"] += ms
        entry["launches"] += 1
        group = group_of(evt.name)
        entry["groups"][group] = entry["groups"].get(group, 0.0) + ms
    for entry in out.values():
        entry["launches"] /= steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))


def idle_by_span(events, steps: int = 1, top: int = 15) -> dict:
    """{"<span> / <op>": idle ms a step}, the ``top`` largest: each gap
    between the device's operations named by the innermost program span
    and the innermost other host event open at its midpoint, on any
    thread."""
    spans, ops = _host(events)
    span_starts = [e.time_range.start for e in spans]
    op_starts = [e.time_range.start for e in ops]
    merged = _merged(events)
    out: dict[str, float] = {}
    for (_, end), (start, _) in zip(merged, merged[1:]):
        t = (end + start) / 2
        span = _open_at(spans, span_starts, t)
        op = _open_at(ops, op_starts, t)
        label = (f"{NO_SPAN if span is None else span.name} / "
                 f"{'host idle' if op is None else op.name}")
        out[label] = out.get(label, 0.0) + (start - end) * 1e-3 / steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:top])
