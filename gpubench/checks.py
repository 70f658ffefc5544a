"""The numbers that decide ``correct``: gaps between what the port
produced and what the plain reference works out from the same inputs and
weights.

Training (by the worst leaf): the gap between the port's norm of a leaf
and the reference's, over the reference's norm of that leaf or of the
median leaf, whichever is larger (some gradients are all but zero).
"""

from __future__ import annotations

import math
import statistics


def rel_gap(value: float, want: float) -> float:
    """|value - want| / |want| (``inf`` where ``want`` is 0 and value is
    not, ``nan`` where either is not finite)."""
    if not (math.isfinite(value) and math.isfinite(want)):
        return math.nan
    if want == 0.0:
        return 0.0 if value == 0.0 else math.inf
    return abs(value - want) / abs(want)


def leaf_gaps(got: dict, want: dict, leaves=None) -> dict:
    """Each of ``leaves`` (default: every leaf of ``want``):
    | |got_l| - |want_l| | / max(|want_l|, median_l |want_l|), from the
    leaves' norms; a leaf missing from ``got``, or not finite, reads
    ``nan``."""
    median = statistics.median(want.values())
    out = {}
    for name in (want if leaves is None else leaves):
        g = got.get(name, math.nan)
        w = want[name]
        out[name] = (abs(g - w) / max(w, median, 1e-30)
                     if math.isfinite(g) else math.nan)
    return out


def worst(gaps: dict) -> float:
    """The worst leaf's gap (``nan`` if any leaf's is)."""
    values = list(gaps.values())
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def share(gaps: dict, q: float) -> float:
    """The gap that a share ``q`` of the leaves reach or stay under (0.5:
    the median leaf's), by ``statistics.quantiles``; ``nan`` if any leaf's
    gap is."""
    values = list(gaps.values())
    if any(math.isnan(v) for v in values):
        return math.nan
    if q == 0.5:
        return statistics.median(values)
    cuts = statistics.quantiles(values, n=100, method="inclusive")
    return cuts[round(q * 100) - 1]


def moving_leaves(first_grad: dict, share: float = 1e-3) -> list:
    """The leaves whose first gradient in the reference is at least
    ``share`` of the median leaf's: the others move under Adam by round-off
    alone, so their change is not compared."""
    median = statistics.median(first_grad.values())
    return [k for k, v in first_grad.items() if v >= share * median]


def leaf_norms(tensors: dict) -> dict:
    """{name: float norm}, with one copy to the host."""
    import torch
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([tensors[k].detach().float().norm() for k in names])
    return dict(zip(names, norms.cpu().tolist()))
