"""Serving artifacts: a model exported with ``torch.export``.

Counterpart of ``sndepth_tpu/serving/export.py`` (a ``jax.export``
StableHLO blob and an Orbax checkpoint there). An artifact directory holds

    model.pt2   ``torch.export.save`` of the traced forward, weights inside
    meta.json   the inputs' shapes and dtypes, the device, torch's version

and :func:`load_artifact` rehydrates it without the model's Python code.
The hand-written kernels a forward reaches are operators of their own
(``torch.ops.sndepth.warp_gather``, ``torch.ops.sndepth.gn_build``, each
with the plain version as its CPU kernel and the CUDA kernel as its CUDA
kernel), so the program traces through them and, exported for ``cuda``,
launches the kernels on the card; loading registers them.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Sequence

import torch

MODEL_FILE = "model.pt2"
META_FILE = "meta.json"


def export_fn(module: torch.nn.Module, example_args: Sequence[torch.Tensor]):
    """``torch.export`` of ``module`` in eval mode, its weights frozen
    (``requires_grad`` off, in place), at the example arguments' shapes:
    an ``ExportedProgram``."""
    module.eval().requires_grad_(False)
    with torch.no_grad():
        return torch.export.export(module, tuple(example_args))


def save_artifact(out_dir: str, module: torch.nn.Module,
                  example_inputs: Sequence[torch.Tensor], device) -> str:
    """Export ``module(*example_inputs)`` on ``device`` into ``out_dir``;
    returns ``out_dir``."""
    device = torch.device(device)
    module = module.to(device)
    inputs = [x.to(device) for x in example_inputs]
    program = export_fn(module, inputs)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, MODEL_FILE))
    meta = {"device": str(device), "torch": torch.__version__,
            "inputs": [{"shape": list(x.shape),
                        "dtype": str(x.dtype).removeprefix("torch.")}
                       for x in inputs]}
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


def load_artifact(art_dir: str) -> tuple[Callable, dict]:
    """(callable, meta). The callable takes the inputs as ``meta`` lists
    them, on its device, and raises ``ValueError`` on any other shape or
    dtype."""
    # Registers the kernels' operators that a program may call.
    import sndepth_tpu_torch.kernels.gn_build  # noqa: F401
    import sndepth_tpu_torch.kernels.warp  # noqa: F401
    with open(os.path.join(art_dir, META_FILE)) as f:
        meta = json.load(f)
    module = torch.export.load(os.path.join(art_dir, MODEL_FILE)).module()
    specs = [(tuple(s["shape"]), getattr(torch, s["dtype"]))
             for s in meta["inputs"]]

    def call(*inputs):
        if len(inputs) != len(specs):
            raise ValueError(f"{len(inputs)} inputs, the artifact takes "
                             f"{len(specs)}")
        for i, (x, (shape, dtype)) in enumerate(zip(inputs, specs)):
            if tuple(x.shape) != shape or x.dtype != dtype:
                raise ValueError(
                    f"input {i}: {tuple(x.shape)} {x.dtype}, the artifact "
                    f"takes {shape} {dtype}")
        with torch.no_grad():
            return module(*inputs)

    return call, meta
