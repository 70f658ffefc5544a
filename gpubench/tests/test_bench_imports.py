"""No module of the benchmark imports the JAX stack or the JAX package,
compared by whole top-level name; the plain references import nothing of
the port either."""

from __future__ import annotations

import ast
import os

import pytest

from gpubench import harness

FILES = sorted(
    os.path.join(dirpath, f)
    for dirpath, _, files in os.walk(harness.HERE)
    for f in files if f.endswith(".py"))
REFERENCE = os.path.join(harness.HERE, "reference")


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, harness.ROOT) for p in FILES])
def test_no_jax_stack(path):
    held = top_level_imports(path) & set(harness.FORBIDDEN_MODULES)
    assert not held, f"{path} imports {held}"
    if path.startswith(REFERENCE):
        assert "sndepth_tpu_torch" not in top_level_imports(path)


def test_whole_name_comparison(monkeypatch):
    """``sndepth_tpu_torch`` begins with ``sndepth_tpu`` and is allowed;
    ``sndepth_tpu.x`` and ``jax.numpy`` are not."""
    import sys
    fake = {"sndepth_tpu_torch.train": None, "jaxtyping": None}
    monkeypatch.setattr(sys, "modules", {**sys.modules, **fake})
    assert harness.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {**sys.modules,
                                         "sndepth_tpu.models": None,
                                         "jax.numpy": None})
    assert harness.forbidden_modules() == ["jax", "sndepth_tpu"]
