"""Full-state checkpoints of the PyTorch port (``train/checkpoint.py``):
the JAX package's ``tests/test_checkpoint.py`` cases, ported; the GeoNet
loop's policy, the JAX loop's (an async writer keeping the last 5); the
params-only layout ``cli/convert_weights`` writes; and ``cli/train_geonet``
under two ranks as ``torchrun`` starts them (spawned processes, one torch
thread each, the group from torchrun's environment on a free localhost
port), with a resume, against the one-process CLI on the same global
batches."""

import os
import shutil

import numpy as np
import pytest
import torch

from sndepth_tpu_torch.core.config import GeoNetConfig
from sndepth_tpu_torch.data.synthetic import synthetic_batches
from sndepth_tpu_torch.train import checkpoint as ckpt_lib
from sndepth_tpu_torch.train import geonet
from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """A GeoNet step file is ~0.4 GB: a test's files go when it ends, so
    that a whole test run does not hold them all at once."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


CFG = GeoNetConfig(batch_size=1, img_height=32, img_width=64,
                   compute_dtype=torch.float32)


def _batch(seed=0):
    return {k: torch.from_numpy(v) for k, v in
            next(synthetic_batches(1, 32, 64, seed=seed)).items()}


def _assert_same(a, b):
    """Equal nested dicts / lists of tensors and numbers, bit for bit."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_save_restore_roundtrip(tmp_path):
    state = geonet.create_train_state(CFG, "cpu")
    geonet.train_step(state, _batch(), CFG)        # Adam's moments exist
    path = ckpt_lib.save_checkpoint(str(tmp_path), state, 7)
    assert path.endswith("step_00000007.pt")
    restored = ckpt_lib.restore_checkpoint(
        str(tmp_path), geonet.create_train_state(CFG, "cpu"))
    _assert_same(state.state_dict(), restored.state_dict())


def test_resume_is_bit_exact(tmp_path):
    """2 steps, a checkpoint, a restore into a fresh state and 1 step equal
    3 steps in a row. On one thread: the CPU's plain versions reduce over
    threads in an order that can change from call to call (PoseNet's
    gradients then part by ~1e-11 at two threads)."""
    with torch_threads(1):
        _resume_is_bit_exact(tmp_path)


def _resume_is_bit_exact(tmp_path):
    batch = _batch()
    s = geonet.create_train_state(CFG, "cpu")
    for _ in range(2):
        geonet.train_step(s, batch, CFG)
    ckpt_lib.save_checkpoint(str(tmp_path), s, s.step)
    geonet.train_step(s, batch, CFG)

    resumed = ckpt_lib.restore_checkpoint(
        str(tmp_path), geonet.create_train_state(CFG, "cpu"))
    geonet.train_step(resumed, batch, CFG)
    assert resumed.step == 3
    _assert_same(s.state_dict(), resumed.state_dict())


def test_latest_step_and_prune(tmp_path):
    state = {"w": torch.arange(3.0)}
    for s in (1, 2, 3):
        ckpt_lib.save_checkpoint(str(tmp_path), state, s, keep=2)
    assert ckpt_lib.latest_step(str(tmp_path)) == 3
    assert sorted(os.listdir(tmp_path)) == ["step_00000002.pt",
                                            "step_00000003.pt"]
    assert ckpt_lib.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt_lib.restore_checkpoint(str(tmp_path / "none"))


def test_async_checkpoint_writer_roundtrip(tmp_path):
    """Saves land complete after ``close()`` and restore bit-exact; what
    the caller changes after ``save`` is not in the file (the host copy is
    taken at the call); the writer keeps ``keep``."""
    state = {"params": {"w": torch.arange(12.0).reshape(3, 4)}, "step": 7}
    d = str(tmp_path / "ck")
    with ckpt_lib.AsyncCheckpointWriter(d, keep=2) as w:
        w.save(state, 100)
        state["params"]["w"] += 1                 # in place, as Adam does
        w.save(state, 200)
        w.save(state, 300)
    assert ckpt_lib.latest_step(d) == 300
    assert sorted(os.listdir(d)) == ["step_00000200.pt", "step_00000300.pt"]
    out = ckpt_lib.restore_checkpoint(d, None, 200)
    np.testing.assert_array_equal(out["params"]["w"].numpy(),
                                  np.arange(12.0).reshape(3, 4) + 1)
    assert out["step"] == 7
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_async_writer_raises_what_its_thread_raised(tmp_path):
    w = ckpt_lib.AsyncCheckpointWriter(str(tmp_path / "ck"))
    w.save({"f": lambda: None}, 1)                # torch.save cannot pickle
    with pytest.raises(Exception):
        w.close()


def test_restore_params_or_state_grafts_a_params_only_file(tmp_path):
    """A params-only file (the nets' state dicts, as ``convert_weights
    geonet`` writes them) grafts onto a train state, whose optimizer and
    counters stay; a file that fits neither layout names the full-state
    error."""
    src = geonet.create_train_state(CFG, "cpu")
    geonet.train_step(src, _batch(), CFG)
    ckpt_lib.save_checkpoint(str(tmp_path / "p"), {
        k: net.state_dict() for k, net in src.nets().items()}, 0)
    state = geonet.create_train_state(CFG, "cpu")
    with pytest.raises(KeyError):
        ckpt_lib.restore_checkpoint(str(tmp_path / "p"), state)
    out = ckpt_lib.restore_params_or_state(str(tmp_path / "p"), state)
    assert out is state and state.step == 0
    _assert_same(state.disp_net.state_dict(), src.disp_net.state_dict())
    _assert_same(state.pose_net.state_dict(), src.pose_net.state_dict())
    ckpt_lib.save_checkpoint(str(tmp_path / "bad"), {"disp_net": {}}, 0)
    with pytest.raises(RuntimeError, match="first error"):
        ckpt_lib.restore_params_or_state(str(tmp_path / "bad"), state)
    dict_state = {"params": {"w": torch.zeros(2)}, "step": 3}
    ckpt_lib.save_checkpoint(str(tmp_path / "d"), {"w": torch.ones(2)}, 0)
    got = ckpt_lib.restore_params_or_state(str(tmp_path / "d"), dict_state)
    assert got["step"] == 3 and torch.equal(got["params"]["w"],
                                            torch.ones(2))


def test_geonet_loop_keeps_the_last_five_checkpoints(tmp_path,
                                                    monkeypatch):
    """The JAX loop's policy: an async writer keeping the last 5 (here 2
    through the writer's own argument, a GeoNet step file being ~0.4 GB);
    the file of the last step is complete when the loop returns."""
    import functools
    import inspect

    from sndepth_tpu_torch.train import loop
    Writer = ckpt_lib.AsyncCheckpointWriter
    assert inspect.signature(Writer).parameters["keep"].default == 5
    monkeypatch.setattr(loop.ckpt_lib, "AsyncCheckpointWriter",
                        functools.partial(Writer, keep=2))
    ckpt_dir = str(tmp_path / "ck")
    state, _ = loop.train_geonet(CFG, synthetic_batches(1, 32, 64, seed=1), 3,
                                 device="cpu", ckpt_dir=ckpt_dir,
                                 log_every=3, ckpt_every=1)
    assert sorted(os.listdir(ckpt_dir)) == [f"step_{s:08d}.pt"
                                            for s in (2, 3)]
    saved = torch.load(loop.latest_checkpoint(ckpt_dir), weights_only=True)
    assert saved["step"] == 3
    _assert_same(saved["disp_net"], state.disp_net.state_dict())


# --- train_geonet under two ranks -------------------------------------------

ARGS = ["--device", "cpu", "--dtype", "float32", "--batch_size", "2",
        "--img_height", "32", "--img_width", "64", "--log_every", "1",
        "--output_ckpt_iter", "1000"]


def _torchrun_worker(rank, world, port, root):
    """A rank as ``torchrun`` starts it on a machine with a card: the group
    from the environment (``MASTER_ADDR``, ``RANK``, ...), and
    ``torch.cuda.is_available()`` true. ``--device cpu`` must then give a
    gloo group, which the CLI's ``initialize_multihost`` makes."""
    import torch.distributed as dist

    from sndepth_tpu_torch.cli import train_geonet
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.cuda.is_available = lambda: True
    torch.set_num_threads(1)
    args = ARGS + ["--ckpt_dir", os.path.join(root, "ck"),
                   "--graphs_dir", os.path.join(root, "logs")]
    try:
        _, first = train_geonet.main(args + ["--max_steps", "1"])
        assert dist.get_backend() == "gloo"
        state, second = train_geonet.main(args + ["--max_steps", "2",
                                                  "--resume"])
        torch.save({"records": first + second, "step": state.step,
                    "disp_net": state.disp_net.state_dict()},
                   os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_geonet_cli_under_two_ranks_resumes_and_matches_one_process(
        tmp_path):
    """Two ranks of ``torchrun``, as the spawned processes stand in for
    them, the one-process CLI meanwhile on a thread of this one."""
    from concurrent.futures import ThreadPoolExecutor

    from sndepth_tpu_torch.cli import train_geonet
    from sndepth_tpu_torch.parallel.multihost import spawn
    root = str(tmp_path / "dp")
    with ThreadPoolExecutor(1) as pool:
        group = pool.submit(spawn, _torchrun_worker, 2,
                            (2, _free_port(), root), 60.0)
        one_args = ARGS + ["--ckpt_dir", str(tmp_path / "one"),
                           "--graphs_dir", str(tmp_path / "one_logs")]
        # The resumed run starts the synthetic stream again, as the
        # two-rank run's does.
        _, first = train_geonet.main(one_args + ["--max_steps", "1"])
        state, second = train_geonet.main(one_args + ["--max_steps", "2",
                                                      "--resume"])
        group.result()
    one = first + second
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"),
                        weights_only=True) for r in range(2)]
    # A file at the end of each run (--output_ckpt_iter past the run).
    assert sorted(os.listdir(os.path.join(root, "ck"))) == [
        f"step_{s:08d}.pt" for s in (1, 2)]
    with open(os.path.join(root, "logs", "metrics.jsonl")) as f:
        assert len(f.readlines()) == 2          # rank 0 alone logs
    for r in ranks:
        assert r["step"] == 2 == state.step
        assert [x["step"] for x in r["records"]] == [1, 2]
        for got, want in zip(r["records"], one):
            np.testing.assert_allclose(got["loss_total"],
                                       want["loss_total"], rtol=1e-5)
        for k, v in r["disp_net"].items():
            torch.testing.assert_close(v, ranks[0]["disp_net"][k], rtol=0,
                                       atol=0)
            assert float((v - state.disp_net.state_dict()[k]).abs().max()
                         ) <= 6 * 2e-4, k
    saved = torch.load(os.path.join(root, "ck", "step_00000002.pt"),
                       weights_only=True)
    assert not any(k.startswith("module.") for k in saved["disp_net"])
