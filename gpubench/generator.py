"""The general generator: every cell's inputs from its traffic mix
(``traffic/<name>.json``: ``kind`` names a file ``traffic_kinds/<kind>.py``,
the rest are its parameters), the sizes of its configuration and
``--seed``, drawn on the device in a few large calls. The same seed gives
the same inputs.

A traffic kind is a module with ``generate(params, seed, device)``; the
harness finds it by name, as it finds drivers and metric readers, so a new
kind is a new file. Each kind draws from :func:`seeded` generators.
"""

from __future__ import annotations

import torch

from gpubench.harness import load_module, sub_seed


def seeded(seed: int, tag: str, device) -> torch.Generator:
    """A generator on ``device`` for one use (``tag``) of the run's seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, tag))
    return gen


def generate(mix: dict, sizes: dict, seed: int, device):
    """The inputs of a traffic mix at the configuration's ``sizes``."""
    kind = load_module("traffic_kinds", mix["kind"], "traffic kind")
    params = {k: v for k, v in mix.items() if k not in ("kind", "why")}
    return kind.generate({**params, **sizes}, seed, device)
