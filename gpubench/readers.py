"""Arithmetic the per-layer readers share (``metrics/<name>.py``). A
reader that finds nothing to read returns ``None``; the harness then leaves
its metric out of the line. Shares of a roofline or a peak are never made
up as 0."""

from __future__ import annotations

import statistics


def per_unit(r, seconds: float) -> float:
    return seconds / r.trace["units"]


def launches_per_unit(r):
    if not r.trace or not r.trace["launches"]:
        return None
    return r.trace["launches"] / r.trace["units"]


def group_ms_per_unit(r, group: str):
    if not r.trace or group not in r.trace["group_s"]:
        return None
    return per_unit(r, r.trace["group_s"][group]) * 1e3


def idle_pct(r):
    """Share of a step or frame with no device operation running: the
    device's busy time a unit in the trace (the union of its operations'
    intervals) against the untraced window's mean unit time, since the
    profiler slows the host and would inflate the idle share of the traced
    window itself."""
    if not r.trace or not r.trace["busy_s"] or not r.units:
        return None
    busy = r.trace["busy_s"] / r.trace["units"]
    return 100.0 * (1.0 - busy / (r.window_s / r.units))


def mfu_pct(r):
    """The reference's convolution and matrix FLOPs of one step or frame
    over the window's mean step or frame time, against the peak of the
    configuration's precision."""
    if not r.flops_per_unit or not r.units or not r.peak_flops_per_s:
        return None
    unit_s = r.window_s / r.units
    return 100.0 * r.flops_per_unit / unit_s / r.peak_flops_per_s


def roofline_pct(r, kernels: tuple):
    """The bounds of these kernels' calls over their device time, over the
    traced steps or frames: the time of the device kernels whose names hold
    one of the names the reference noted with the calls."""
    if not r.trace:
        return None
    bound = sum(r.bounds.get(k, 0.0) for k in kernels) * r.trace["units"]
    names = {n for k in kernels for n in r.kernel_names.get(k, ())}
    spent = sum(s for op, s in r.trace["op_s"].items()
                if any(n in op for n in names))
    if bound <= 0.0 or spent <= 0.0:
        return None
    return 100.0 * bound / spent


def span_mean_ms(r, span: str):
    values = r.spans.get(span)
    if not values:
        return None
    return statistics.fmean(values) * 1e3
