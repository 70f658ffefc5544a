"""The GeoNet train step as replays of CUDA graphs
(``train/geonet._StepGraphs``).

On the CPU: which calls engage the graphs (a batch of CUDA tensors on one
process with grad mode on, shown with fake CUDA tensors), and that every
other step, a CPU step among them, runs eagerly; the step's returned
tensors; a restored state holds no graph; a checkpoint of a state whose
Adam kept its step counts on the card resumes on the CPU.

On a card (the ``card`` tests; without one they skip): both stages over
five steps through the graphs against the eager step from the same
weights, a non-finite batch skipped through the graph, a batch of another
shape, another config or optimizer, a restored checkpoint, one written
with Adam's step counts on the host, and a replay's launch counters
against the device kernels in its profile. This
file imports no JAX, so on a machine with a card and no JAX:
``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_step_graphs.py -q``.
"""

from __future__ import annotations

import copy
import dataclasses
import io

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from sndepth_tpu_torch.core.config import GeoNetConfig
from sndepth_tpu_torch.data.synthetic import synthetic_batches
from sndepth_tpu_torch.train import geonet
from sndepth_tpu_torch.utils import tracing
from sndepth_tpu_torch.utils.threads import torch_threads

GRAPH_COUNTERS = ("graph_captures", "graph_replays", "eager_steps")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


def _counted(fn):
    """``fn()``'s result and the counters it moved."""
    before = tracing.counts()
    out = fn()
    after = tracing.counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def _batches(b, h, w, n, device, seed=0):
    stream = synthetic_batches(b, h, w, seed=seed)
    return [{k: torch.from_numpy(v).to(device) for k, v in
             next(stream).items()} for _ in range(n)]


# On the CPU.

CPU_CFG = GeoNetConfig(batch_size=1, img_height=32, img_width=64,
                       compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def cpu_state():
    return geonet.create_train_state(CPU_CFG, "cpu")


def test_a_cpu_step_runs_eagerly(cpu_state):
    batch, = _batches(1, 32, 64, 1, "cpu")
    out, moved = _counted(lambda: geonet.train_step(cpu_state, batch,
                                                    CPU_CFG))
    assert moved["eager_steps"] == 1
    assert "graph_captures" not in moved and "graph_replays" not in moved
    assert cpu_state._graphs is None
    assert not cpu_state.optimizer.defaults["capturable"]
    assert np.isfinite(float(out["loss_total"]))


@pytest.mark.parametrize("call, graphs", [
    ("one process", True), ("nets", False), ("ranks", False),
    ("no grad", False), ("cpu batch", False)])
def test_only_a_one_process_step_on_cuda_tensors_engages(monkeypatch,
                                                         cpu_state, call,
                                                         graphs):
    """The choice, with fake CUDA tensors: no kernel runs."""
    taken = []
    monkeypatch.setattr(geonet, "_graph_step",
                        lambda *a, **k: taken.append("graphs"))
    monkeypatch.setattr(geonet, "_eager_step",
                        lambda *a, **k: taken.append("eager"))
    device = "cpu" if call == "cpu batch" else "cuda"
    with FakeTensorMode():
        batch = {"tgt": torch.empty(1, 32, 64, 3, dtype=torch.uint8,
                                    device=device),
                 "src": torch.empty(1, 32, 64, 6, dtype=torch.uint8,
                                    device=device),
                 "intrinsics": torch.empty(1, 3, 3, device=device)}
    kwargs = {"nets": {"nets": (cpu_state.disp_net, cpu_state.pose_net,
                                None)},
              "ranks": {"ranks": object()}}.get(call, {})
    with torch.set_grad_enabled(call != "no grad"):
        geonet.train_step(cpu_state, batch, CPU_CFG, **kwargs)
    assert taken == ["graphs" if graphs else "eager"]


def test_consecutive_steps_return_distinct_tensors(cpu_state):
    first, second = (geonet.train_step(cpu_state, b, CPU_CFG)
                     for b in _batches(1, 32, 64, 2, "cpu", seed=1))
    kept = {k: v.clone() for k, v in first.items()}
    assert list(first) == list(second)
    for k in first:
        assert first[k] is not second[k]
        assert first[k].data_ptr() != second[k].data_ptr()
        assert torch.equal(first[k], kept[k])


def test_a_checkpoint_with_adam_on_the_card_resumes_on_the_cpu(cpu_state):
    """A card's Adam keeps its step counts there (``capturable``); a CPU
    state that loads its checkpoint keeps its own choice, and steps."""
    batch, = _batches(1, 32, 64, 1, "cpu", seed=6)
    geonet.train_step(cpu_state, batch, CPU_CFG)
    saved = copy.deepcopy(cpu_state.state_dict())
    for group in saved["optimizer"]["param_groups"]:
        group["capturable"] = True
    state = geonet.create_train_state(CPU_CFG, "cpu")
    state.load_state_dict(saved)
    assert not any(g["capturable"] for g in state.optimizer.param_groups)
    out = geonet.train_step(state, batch, CPU_CFG)
    assert (state.step, state.notfinite_count) == (saved["step"] + 1, 0)
    assert np.isfinite(float(out["loss_total"]))


def test_load_state_dict_drops_the_graphs(cpu_state):
    cpu_state._graphs = object()
    cpu_state.load_state_dict(cpu_state.state_dict())
    assert cpu_state._graphs is None
    assert "_graphs" not in cpu_state.state_dict()


# On a card.

B, H, W = 4, 128, 416
# In bf16, the cells' precision, the stage-1 step is bit-reproducible on
# the card, and graph and eager steps are held bit-equal. Elsewhere (the
# stage-2 step in any precision, float32 even with cuDNN's deterministic
# algorithms) two eager steps from the same state already part in their
# gradients' last bits (the splat's atomics; the step is not
# bit-reproducible), and Adam turns such bits into a whole step of a
# near-zero weight, so gaps grow over steps between any two runs. There,
# each step is compared from the same state: the graph step's state
# against an eager twin's must lie within SPREAD times the gap between two
# eager twins, or within REL. A step that used stale inputs, gradients or
# moments lands orders of magnitude further off.
REL = 1e-6
SPREAD = 10.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = deterministic


def _config(train_flow: bool) -> GeoNetConfig:
    return GeoNetConfig(batch_size=B, img_height=H, img_width=W,
                        compute_dtype=torch.float32, train_flow=train_flow)


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, or ||a - b|| where b is 0."""
    scale = float(b.norm())
    gap = float((a - b).norm())
    return gap / scale if scale else gap


def _state_gap(got: geonet.TrainState, want: geonet.TrainState) -> float:
    """The widest relative gap of a parameter or an Adam moment; the
    counters and Adam's step counts must be equal."""
    assert (got.step, got.notfinite_count) == (want.step,
                                               want.notfinite_count)
    gaps = [0.0]
    for p, q in zip(got.parameters(), want.parameters()):
        gaps.append(_rel_gap(p.detach(), q.detach()))
        sp, sq = got.optimizer.state.get(p, {}), want.optimizer.state.get(q,
                                                                          {})
        assert sp.keys() == sq.keys()
        if sp:
            assert float(sp["step"]) == float(sq["step"])
            gaps += [_rel_gap(sp[m], sq[m]) for m in ("exp_avg",
                                                      "exp_avg_sq")]
    return max(gaps)


def _assert_same_parts(got: dict, want: dict, rel: float = REL):
    assert list(got) == list(want)
    for k in got:
        a, b = float(got[k]), float(want[k])
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= rel * abs(b)


def _steps_against_eager(state, batches, cfg, device):
    """Each batch through ``train_step``, each step checked against two
    eager twins' steps on the same batch from the same state: returns the
    steps' loss parts and the counters each moved."""
    twins = [geonet.create_train_state(cfg, device) for _ in range(2)]
    outs, moved = [], []
    for batch in batches:
        saved = state.state_dict()
        for twin in twins:
            twin.load_state_dict(copy.deepcopy(saved))
        out, m = _counted(lambda: geonet.train_step(state, batch, cfg))
        want, eager = _counted(lambda: geonet._eager_step(twins[0], batch,
                                                          cfg))
        geonet._eager_step(twins[1], batch, cfg)
        # The forward is deterministic: equal parts from equal states.
        _assert_same_parts(out, want)
        assert _state_gap(state, twins[0]) <= max(
            REL, SPREAD * _state_gap(twins[1], twins[0]))
        # A replay counts the hand-written kernels' launches an eager step
        # makes; the capture's own counts stand for the replay after it.
        assert ({k: n for k, n in m.items() if k not in GRAPH_COUNTERS}
                == {k: n for k, n in eager.items()
                    if k not in GRAPH_COUNTERS})
        outs.append((out, {k: float(v) for k, v in out.items()}))
        moved.append(m)
    # Each step's parts are its own, not the graph's output buffer, which
    # later steps overwrite.
    for out, values in outs:
        assert {k: float(v) for k, v in out.items()} == pytest.approx(
            values, rel=0, abs=0, nan_ok=True)
    return [out for out, _ in outs], moved


def _counter(moved, name):
    return [m.get(name, 0) for m in moved]


@pytest.mark.card
@pytest.mark.parametrize("train_flow", [False, True], ids=["stage1",
                                                           "stage2"])
def test_graph_steps_match_eager_steps(card, train_flow):
    cfg = _config(train_flow)
    state = geonet.create_train_state(cfg, card)
    assert state.optimizer.defaults["capturable"]
    got, moved = _steps_against_eager(state, _batches(B, H, W, 5, card),
                                      cfg, card)
    assert _counter(moved, "eager_steps") == [1, 0, 0, 0, 0]
    assert _counter(moved, "graph_captures") == [0, 1, 0, 0, 0]
    assert _counter(moved, "graph_replays") == [0, 1, 1, 1, 1]
    ptrs = {v.data_ptr() for out in got for v in out.values()}
    assert len(ptrs) == 5 * len(got[0])


@pytest.mark.card
def test_stage1_graph_steps_are_bit_equal_to_eager_steps_in_bf16(card):
    cfg = GeoNetConfig(batch_size=B, img_height=H, img_width=W)
    assert cfg.compute_dtype == torch.bfloat16
    batches = _batches(B, H, W, 5, card, seed=1)
    graph_state = geonet.create_train_state(cfg, card)
    eager_state = geonet.create_train_state(cfg, card)
    for batch in batches:
        _assert_same_parts(geonet.train_step(graph_state, batch, cfg),
                           geonet._eager_step(eager_state, batch, cfg), 0.0)
    assert _state_gap(graph_state, eager_state) == 0.0
    assert isinstance(graph_state._graphs, geonet._StepGraphs)
    assert graph_state._graphs.adam is not None


@pytest.mark.card
def test_a_nonfinite_batch_is_skipped_through_the_graph(card):
    """Non-finite at the warm-up, which then lasts until step 2 has made
    Adam's state (the graphs are captured at step 3), and at step 4, a
    replay."""
    cfg = _config(True)
    batches = _batches(B, H, W, 5, card, seed=2)
    for i in (0, 3):
        batches[i] = dict(batches[i], intrinsics=torch.full_like(
            batches[i]["intrinsics"], float("nan")))
    state = geonet.create_train_state(cfg, card)
    got, moved = _steps_against_eager(state, batches, cfg, card)
    assert _counter(moved, "eager_steps") == [1, 1, 0, 0, 0]
    assert _counter(moved, "graph_captures") == [0, 0, 1, 0, 0]
    assert _counter(moved, "graph_replays") == [0, 0, 1, 1, 1]
    assert np.isnan(float(got[0]["loss_total"]))
    assert np.isnan(float(got[3]["loss_total"]))
    assert state.notfinite_count == 0 and state.step == 5
    assert state._graphs.adam is not None


@pytest.mark.card
def test_another_shape_runs_eagerly_and_the_old_key_is_captured_again(
        card):
    cfg = _config(False)
    batches = _batches(B, H, W, 5, card, seed=3)
    small, = _batches(2, H, W, 1, card, seed=4)
    state = geonet.create_train_state(cfg, card)
    _, moved = _steps_against_eager(
        state, batches[:2] + [small] + batches[2:], cfg, card)
    assert _counter(moved, "eager_steps") == [1, 0, 1, 1, 0, 0]
    assert _counter(moved, "graph_captures") == [0, 1, 0, 0, 1, 0]
    assert _counter(moved, "graph_replays") == [0, 1, 0, 0, 1, 1]


@pytest.mark.card
def test_a_restored_checkpoint_matches_eager_afterwards(card):
    """Three steps, a checkpoint, two steps, the checkpoint restored, and
    the last two steps again, each against the eager step."""
    cfg = _config(True)
    batches = _batches(B, H, W, 5, card, seed=5)
    state = geonet.create_train_state(cfg, card)
    _steps_against_eager(state, batches[:3], cfg, card)
    saved = io.BytesIO()
    torch.save(state.state_dict(), saved)
    _steps_against_eager(state, batches[3:], cfg, card)
    saved.seek(0)
    state.load_state_dict(torch.load(saved, map_location=card))
    assert state._graphs is None and state.step == 3
    _, moved = _steps_against_eager(state, batches[3:], cfg, card)
    assert _counter(moved, "eager_steps") == [1, 0]
    assert _counter(moved, "graph_replays") == [0, 1]


@pytest.mark.card
def test_another_config_or_optimizer_is_captured_anew(card):
    """A graph holds its config's loss weights and its optimizer's
    tensors: a step with another config of the same stage, or after the
    optimizer is replaced, warms up and captures anew."""
    cfg = _config(False)
    other = dataclasses.replace(cfg, loss_weight_disparity_smooth=1.0)
    batches = _batches(B, H, W, 6, card, seed=7)
    state = geonet.create_train_state(cfg, card)
    moved = [_steps_against_eager(state, batches[:2], cfg, card)[1],
             _steps_against_eager(state, batches[2:4], other, card)[1]]
    optimizer = geonet.make_optimizer(other, state.parameters())
    optimizer.load_state_dict(state.optimizer.state_dict())
    state.optimizer = optimizer
    moved.append(_steps_against_eager(state, batches[4:], other, card)[1])
    for m in moved:
        assert _counter(m, "eager_steps") == [1, 0]
        assert _counter(m, "graph_captures") == [0, 1]
        assert _counter(m, "graph_replays") == [0, 1]


@pytest.mark.card
def test_a_checkpoint_with_adam_on_the_host_resumes_through_the_graphs(
        card):
    """Written by a run whose Adam kept its step counts on the host (a CPU
    run, or a card's before the graphs) and restored as
    ``checkpoint.restore_checkpoint`` does, through the host: the graphs
    then capture Adam's update."""
    cfg = _config(True)
    batches = _batches(B, H, W, 5, card, seed=9)
    state = geonet.create_train_state(cfg, card)
    _steps_against_eager(state, batches[:2], cfg, card)
    saved = copy.deepcopy(state.state_dict())
    for group in saved["optimizer"]["param_groups"]:
        group["capturable"] = False
    for adam in saved["optimizer"]["state"].values():
        adam["step"] = adam["step"].cpu()
    buf = io.BytesIO()
    torch.save(saved, buf)
    buf.seek(0)
    resumed = geonet.create_train_state(cfg, card)
    resumed.load_state_dict(torch.load(buf, map_location="cpu",
                                       weights_only=True))
    assert all(g["capturable"] for g in resumed.optimizer.param_groups)
    assert all(a["step"].is_cuda for a in resumed.optimizer.state.values())
    _, moved = _steps_against_eager(resumed, batches[2:], cfg, card)
    assert _counter(moved, "eager_steps") == [1, 0, 0]
    assert _counter(moved, "graph_replays") == [0, 1, 1]


# The device kernels of the hand-written kernels' counters, by a part of
# their names (as ``gpubench/trace.py`` groups them).
KERNEL_NAMES = {"photo_pair_kernel": ("K1", "K3", "K4"),
                "smooth_kernel": ("K2",),
                "warp_gather_kernel": ("K5",),
                "warp_coord_grad_kernel": ("K5b",),
                "warp_splat": ("K6",),
                "dssim_fwd_kernel": ("K7",),
                "dssim_bwd_kernel": ("K7b",)}


@pytest.mark.card
def test_a_replay_launches_the_kernels_its_counters_copy(card):
    """A replayed step's kernel counters are copied from the capture; its
    profile holds as many launches of each hand-written kernel."""
    cfg = _config(True)
    batches = _batches(B, H, W, 3, card, seed=8)
    state = geonet.create_train_state(cfg, card)
    for batch in batches[:2]:
        geonet.train_step(state, batch, cfg)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, moved = _counted(lambda: geonet.train_step(state, batches[2],
                                                      cfg))
        torch.cuda.synchronize()
    assert moved["graph_replays"] == 1 and "graph_captures" not in moved
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    for kernel, counters in KERNEL_NAMES.items():
        launched = sum(kernel in name for name in names)
        assert launched == sum(moved.get(c, 0) for c in counters) > 0, kernel
