"""Host input threads and host-to-device prefetch.

Counterpart of ``sndepth_tpu/data/prefetch.py`` (which imports jax):
worker threads run dataset iterators, and batches go to the device from
pinned memory with ``non_blocking=True`` while earlier steps run.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from sndepth_tpu_torch.utils import tracing


def threaded_batches(make_iter: Callable[[], Iterator[dict]],
                     num_threads: int = 4, buffer_size: int = 8
                     ) -> Iterator[dict]:
    """Run ``make_iter()`` iterators in ``num_threads`` worker threads;
    the order across threads is nondeterministic."""
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    sentinel = object()

    def worker() -> None:
        try:
            for item in make_iter():
                if stop.is_set():
                    return
                q.put(item)
        finally:
            q.put(sentinel)

    for _ in range(num_threads):
        threading.Thread(target=worker, daemon=True).start()
    finished = 0
    try:
        while finished < num_threads:
            item = q.get()
            if item is sentinel:
                finished += 1
                continue
            yield item
    finally:
        stop.set()


@tracing.span("input#to_device")
def to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on ``device``; CUDA copies go from pinned
    memory and do not block the host."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def device_prefetch(batches: Iterator[dict], device: torch.device,
                    size: int = 2) -> Iterator[dict]:
    """Keep ``size`` batches on their way to ``device`` ahead of use."""
    buf = []
    for batch in batches:
        buf.append(to_device(batch, device))
        if len(buf) >= size:
            yield buf.pop(0)
    while buf:
        yield buf.pop(0)
