"""Full-train-state checkpoints: one ``torch.save`` file a step.

Counterpart of ``sndepth_tpu/train/checkpoint.py`` (Orbax there). A
checkpoint is ``<ckpt_dir>/step_%08d.pt``: a dict of tensors, nested dicts
and numbers, as ``state_dict()`` of a train state gives it (the GeoNet
state's: the nets' state dicts, the optimizer's, the step and the skip
counter), so resume is bit-exact. A directory keeps the last ``keep``
steps (5, as the JAX loop keeps).

:class:`AsyncCheckpointWriter` keeps the write off the train loop: the
caller copies the state to host memory, a background thread serialises it
to a temporary name and renames it into place, and the next ``save`` (or
``close``) joins the write in flight and prunes.

A state here is a dict, or an object with ``state_dict()`` and
``load_state_dict()`` (such as ``train.geonet.TrainState``).
"""

from __future__ import annotations

import logging
import os
import re
import threading
from typing import Any

import torch

FILE_PATTERN = "step_%08d.pt"
_STEP_RE = re.compile(r"^step_(\d+)\.pt$")


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, FILE_PATTERN % step)


def to_host(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor copied to host memory (a CPU
    tensor cloned too: the optimizer updates its moments in place)."""
    if hasattr(obj, "state_dict") and not isinstance(obj, dict):
        obj = obj.state_dict()
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _write(host_state: dict, path: str) -> None:
    torch.save(host_state, path + ".tmp")
    os.replace(path + ".tmp", path)


def save_checkpoint(ckpt_dir: str, state: Any, step: int,
                    keep: int = 5) -> str:
    """Write ``state`` as step ``step`` of ``ckpt_dir``, then prune to the
    last ``keep``; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    _write(to_host(state), path)
    _prune(ckpt_dir, keep)
    return path


class AsyncCheckpointWriter:
    """Saves that do not block the train loop: the device-to-host copy on
    the caller, the disk write on a background thread. ``wait()`` (or the
    next ``save``) joins the write in flight and re-raises its error;
    ``close()`` (or leaving the ``with`` block) before reading the
    directory. The disk holds at most ``keep + 1`` steps at a time."""

    def __init__(self, ckpt_dir: str, keep: int = 5):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.keep = keep
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, state: Any, step: int) -> str:
        self.wait()
        path = checkpoint_path(self.ckpt_dir, step)
        host_state = to_host(state)

        def run():
            try:
                _write(host_state, path)
            except Exception as exc:            # raised again by wait()
                self._error = exc

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return path

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error
        _prune(self.ckpt_dir, self.keep)

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_RE.match,
                                               os.listdir(ckpt_dir)) if m)


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, target: Any = None,
                       step: int | None = None) -> Any:
    """Read step ``step`` (default: the latest) of ``ckpt_dir``. Without
    ``target`` returns the saved dict; else loads it into ``target``
    (``load_state_dict``; a dict target takes the saved dict's entries,
    which must have its keys) and returns ``target``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    saved = torch.load(checkpoint_path(ckpt_dir, step), map_location="cpu",
                       weights_only=True)
    if target is None:
        return saved
    if isinstance(target, dict):
        missing = set(target) - set(saved)
        if missing:
            raise KeyError(f"step {step} of {ckpt_dir} lacks {sorted(missing)}")
        return {k: saved[k] for k in target}
    target.load_state_dict(saved)
    return target


def restore_params_or_state(ckpt_dir: str, state: Any,
                            step: int | None = None) -> Any:
    """Restore either a full train state or a params-only checkpoint (what
    ``cli/convert_weights`` writes: the nets' state dicts and nothing else)
    into ``state``, so that one ``--ckpt_dir`` takes both. A params-only
    file is grafted onto ``state``'s nets (``state.nets()``, or the
    ``"params"`` entry of a dict state); the optimizer and counters keep
    their values. When neither form fits, the error names the full-state
    failure too."""
    try:
        return restore_checkpoint(ckpt_dir, state, step)
    except FileNotFoundError:
        raise
    except Exception as exc:
        full_state_err = exc
        logging.info("full-state restore failed (%s: %s); trying the "
                     "params-only layout", type(exc).__name__, exc)
    try:
        saved = restore_checkpoint(ckpt_dir, None, step)
        if isinstance(state, dict):
            return {**state, "params": restore_checkpoint(
                ckpt_dir, dict(state["params"]), step)}
        for key, net in state.nets().items():
            net.load_state_dict(saved[key])
        return state
    except Exception as exc:
        raise RuntimeError(
            f"checkpoint at {ckpt_dir!r} matched neither the train-state "
            f"layout (first error: {type(full_state_err).__name__}: "
            f"{full_state_err}) nor a params-only layout") from exc


def _prune(ckpt_dir: str, keep: int) -> None:
    for step in _steps(ckpt_dir)[:-keep]:
        try:
            os.remove(checkpoint_path(ckpt_dir, step))
        except FileNotFoundError:
            pass

