"""A cap on PyTorch's intra-op threads for a stretch of work."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the body with at most ``n`` intra-op threads, then restore the
    count. Several processes sharing the machine's cores (test workers, a
    data loader beside the trainer) get through sooner with a few threads
    each than with a pool as wide as the machine in every one."""
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, min(before, n)))
    try:
        yield
    finally:
        torch.set_num_threads(before)
