"""Process groups across processes and hosts (``torch.distributed``).

Counterpart of ``sndepth_tpu/parallel/multihost.py``. A data-parallel run
is one process a card, started by ``torchrun --nproc_per_node N`` (and
``--nnodes`` / ``--rdzv_endpoint`` across hosts); each process calls
:func:`initialize_multihost` first. Without a group every helper here
acts as one process does.

:func:`run_local_group` starts N processes on this host itself, each with
the group initialised through a file in a given directory: what the tests
and ``chip_smoke.py`` use to run a group without torchrun or a port.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def default_backend(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device="cuda") -> dict:
    """Join the process group and return a summary of it.

    With ``num_processes`` > 1, ``coordinator_address`` (``host:port``) and
    ``process_id`` say where the group meets; without them the group is
    torchrun's (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``
    in the environment). At world size 1, or when a group is already up,
    nothing is started. The backend is the one of ``device``, the device
    the run computes on (:func:`default_backend`); a torchrun process on
    CUDA takes the card of its ``LOCAL_RANK``."""
    if not is_distributed():
        env_world = int(os.environ.get("WORLD_SIZE", "1"))
        n = num_processes if num_processes is not None else env_world
        if n > 1:
            backend = default_backend(device)
            kw: dict[str, Any] = {}
            if num_processes is not None:
                kw = {"init_method": f"tcp://{coordinator_address}",
                      "world_size": num_processes, "rank": process_id}
            if backend == "nccl" and "LOCAL_RANK" in os.environ:
                torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
            dist.init_process_group(backend, **kw)
    return {"process_index": rank(), "process_count": world_size(),
            "local_devices": torch.cuda.device_count(),
            "backend": dist.get_backend() if is_distributed() else None}


def local_device(device) -> torch.device:
    """``device``, with a bare ``cuda`` taken as this process's card
    (``LOCAL_RANK`` under torchrun)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", torch.cuda.current_device())))
    return device


def per_host_batch_slice(global_batch: int, index: int | None = None,
                         count: int | None = None) -> tuple[int, int]:
    """(size, offset) of part ``index`` of ``count`` equal parts of a
    global batch of ``global_batch``: by default this rank's part over the
    group. Raises unless the batch divides."""
    index = rank() if index is None else index
    count = world_size() if count is None else count
    if global_batch % count:
        raise ValueError(f"batch {global_batch} does not divide over "
                         f"{count} ranks")
    per = global_batch // count
    return per, per * index


def make_global_batch(batch: dict, index: int | None = None,
                      count: int | None = None) -> dict:
    """This rank's part of a global ``batch`` (numpy arrays or tensors on
    their leading axis), or part ``index`` of ``count``
    (:func:`per_host_batch_slice`): the port's one slicer of a batch.

    Under DDP the global batch is the union of the ranks' parts and each
    rank holds only its own; DDP's gradient average makes the step the
    global batch's. A loader that reads only a rank's part
    (``data/kitti_sequence.batch_iterator``'s ``part``) needs no slicing.
    Without a group the part is the batch."""
    per, off = per_host_batch_slice(len(next(iter(batch.values()))),
                                    index, count)
    return {k: v[off:off + per] for k, v in batch.items()}


def sync_hosts(name: str = "barrier") -> None:
    """A barrier across the group (none without one): around checkpoint
    writes and reads, so that ranks do not race the file system."""
    del name
    if is_distributed():
        dist.barrier()


def broadcast_from_host0(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (without a group: ``obj``)."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _group_entry(rank_: int, fn: Callable, world: int, init_file: str,
                 timeout_s: float, threads: int, args: tuple) -> None:
    torch.set_num_threads(threads)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank_,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank_, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(entry: Callable, world: int, args: tuple,
          timeout_s: float = 60.0) -> None:
    """Run ``entry(i, *args)`` for i < ``world`` in spawned processes
    (``entry`` importable by name: a module-level function). Raises if a
    process fails, or if they have not all finished within ``timeout_s``
    seconds of their start (they are then killed)."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(entry, args=args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{world} processes did not finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def run_local_group(fn: Callable, world: int, init_dir: str, *args,
                    timeout_s: float = 60.0, threads: int = 1) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes of
    one gloo group (which carries CPU and CUDA tensors alike), initialised
    through a file in ``init_dir`` (no port), each at ``threads`` intra-op
    threads (:func:`spawn`, with its ``timeout_s``; the collectives time
    out after as long)."""
    os.makedirs(init_dir, exist_ok=True)
    init_file = os.path.join(init_dir, "group_init")
    if os.path.exists(init_file):
        os.remove(init_file)
    spawn(_group_entry, world,
          (fn, world, init_file, timeout_s, threads, args), timeout_s)
