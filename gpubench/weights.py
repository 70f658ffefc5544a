"""The benchmark's own seeded weights: one state dict drawn on the device
from ``--seed`` in one large call, loaded into the port and into the plain
reference alike.

A configuration's reference gives, for each leaf, how it is drawn:
``("normal", std)`` (a slice of the one standard-normal draw, scaled) or
``("const", value)``.
"""

from __future__ import annotations

import math

import torch

from gpubench.harness import sub_seed


def draw(rules: list, seed: int, device) -> dict:
    """``rules``: ``[(name, shape, (kind, value)), ...]`` in a fixed order.
    Returns ``{name: float32 tensor on device}``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    total = sum(math.prod(shape) for _, shape, (kind, _) in rules
                if kind == "normal")
    noise = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, (kind, value) in rules:
        n = math.prod(shape)
        if kind == "normal":
            out[name] = (noise[at:at + n] * value).reshape(shape)
            at += n
        elif kind == "const":
            out[name] = torch.full(shape, float(value), device=device)
        else:
            raise ValueError(f"{name}: unknown rule {kind!r}")
    return out


def split(state: dict, prefix: str) -> dict:
    """The entries under ``prefix.``, without it."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in state.items() if k.startswith(p)}
