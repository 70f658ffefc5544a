"""Data-parallel, FSDP, tensor-, sequence- and pipeline-parallel runs of
the PyTorch port on the CPU, in spawned gloo groups, against the JAX
package's sharded programs and layers on its 8 virtual CPU devices.

Each group starts through ``parallel.multihost.run_local_group``: a file
store under ``tmp_path`` (no port: six test workers would collide), one
torch thread a process, a 60 s limit. The JAX side is compiled once a
module. This module imports neither JAX nor the JAX package at its top, so
that the spawned processes, which import it for their entry points, start
without them.

DDP: 2 ranks, a global batch of 4 at 32x64 (2 scales), one float32 step
of stage 1 and of stage 2, against
``sndepth_tpu.parallel.mesh.make_parallel_train_step`` on two devices and
against the port's one-process step on the global
batch, at the tolerances of ``test_torch_geonet.py`` and
``test_torch_geonet_flow.py``: loss parts rtol 1e-5 / 2e-5; parameters
after Adam within 2e-6 but for at most 0.1% of entries (gradients within
rounding of zero), none beyond 2 * lr. In stage 2 PoseNet's pose head is
scaled by 1000 and the second shard's focal lengths by 2, so the flows
span pixels and the consistency masks' means part between the shards:
a step that normalised by its shard's mask mean fails the loss check.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


B, H, W = 4, 32, 64
# Two scales of the four: the reductions act on each scale alike, and the
# JAX compiles of the two steps take half as long (four scales of both
# steps are held against JAX in ``test_torch_geonet*.py``).
NUM_SCALES = 2
POSE_SCALE = 1000.0
FOCAL_SCALE = 2.0
LR = 2e-4
PARTS1 = ("loss_total", "loss_rigid_warp", "loss_disp_smooth")
PARTS2 = PARTS1 + ("loss_full_warp", "loss_full_smooth",
                   "loss_geometric_consistency")


def _tcfg(train_flow: bool, batch_size: int = B):
    from sndepth_tpu_torch.core.config import GeoNetConfig
    return GeoNetConfig(batch_size=batch_size, img_height=H, img_width=W,
                        num_scales=NUM_SCALES, compute_dtype=torch.float32,
                        train_flow=train_flow)


def _batch(train_flow: bool) -> dict:
    from sndepth_tpu_torch.data.synthetic import synthetic_batches
    batch = next(synthetic_batches(B, H, W, seed=3))
    rng = np.random.RandomState(3)
    k = batch["intrinsics"] * rng.uniform(0.9, 1.1, (B, 3, 3))
    if train_flow:
        k[B // 2:, 0, 0] *= FOCAL_SCALE
        k[B // 2:, 1, 1] *= FOCAL_SCALE
    batch["intrinsics"] = k.astype(np.float32)
    return batch


def _load(state, weights: dict) -> None:
    for key, net in state.nets().items():
        net.load_state_dict(weights[key])


def _named(state) -> dict:
    return {f"{key}.{k}": p.detach().clone()
            for key, net in state.nets().items()
            for k, p in net.named_parameters()}


# --- entry points of the spawned processes ---------------------------------

def _same_on_every_rank(params: dict) -> bool:
    import torch.distributed as dist
    same = True
    for p in params.values():
        q = p.clone()
        dist.broadcast(q, src=0)
        same = same and torch.equal(p, q)
    return same


def _geonet_worker(rank, world, io_dir):
    """DDP steps of stage 1 and 2, a step whose rank-1 shard is not
    finite, and an FSDP step, each from the weights the parent wrote, then
    a one-process step on the global batch. Rank 0 writes its parameters;
    each rank says whether they are the same bits as rank 0's, and, after
    the non-finite step, as the initial weights."""
    from sndepth_tpu_torch.parallel import fsdp, mesh as pmesh
    from sndepth_tpu_torch.train import geonet as tgeo
    inputs = torch.load(os.path.join(io_dir, "inputs.pt"), weights_only=False)
    mesh = pmesh.make_mesh("cpu")
    out = {}
    for case, train_flow in (("stage1", False), ("stage2", True),
                             ("nonfinite", False), ("fsdp", False)):
        cfg = _tcfg(train_flow)
        weights = inputs["stage2" if train_flow else "stage1"]["weights"]
        batch = dict(inputs["stage2" if train_flow else "stage1"]["batch"])
        if case == "nonfinite" and rank == 1:
            batch["intrinsics"] = np.full_like(batch["intrinsics"], np.nan)
        state = tgeo.create_train_state(cfg, "cpu")
        _load(state, weights)
        if case == "fsdp":
            state = fsdp.shard_state(state, mesh, cfg)
            full = sum(p.numel() * 4 * 3 for p in state.parameters())
            step = fsdp.make_fsdp_train_step(cfg, mesh)
        else:
            step = pmesh.make_parallel_train_step(cfg, mesh)
        shard = pmesh.shard_batch(
            {k: torch.from_numpy(v) for k, v in batch.items()}, mesh)
        metrics = step(state, shard)
        record = {"metrics": {k: float(v) for k, v in metrics.items()},
                  "step": state.step,
                  "notfinite_count": state.notfinite_count}
        if case == "fsdp":
            record["bytes"] = fsdp.sharded_param_bytes_per_device(state)
            record["full_bytes"] = full
        else:
            params = _named(state)
            record["same_as_rank0"] = _same_on_every_rank(params)
            if case == "nonfinite":
                record["kept_weights"] = all(
                    torch.equal(p, weights[k.split(".", 1)[0]][
                        k.split(".", 1)[1]]) for k, p in params.items())
            elif rank == 0:
                record["params"] = params
        out[case] = record
    # The one-process step on the global batch, here rather than in the
    # test's process, whose threads compile the JAX steps: stage 1 on rank
    # 0, stage 2 and the shards' mask means on rank 1.
    case, train_flow = (("stage1", False), ("stage2", True))[rank]
    out["single"] = {case: _one_process(train_flow, **inputs[case])}
    if train_flow:
        out["masks"] = _shard_mask_means(**inputs[case])
    torch.save(out, os.path.join(io_dir, f"rank{rank}.pt"))


def _run_group(fn, world, tmp_path, *args):
    from sndepth_tpu_torch.parallel.multihost import run_local_group
    run_local_group(fn, world, str(tmp_path / "store"), *args,
                    timeout_s=60.0)


class _Background:
    """``fn(*args)`` on a thread of this process, so that work overlaps
    (a spawned group, XLA's compiles, torch's ops: each releases the
    interpreter lock); ``join()`` returns its result or re-raises what it
    raised."""

    def __init__(self, fn, *args):
        import threading
        self.result = self.error = None
        self.thread = threading.Thread(target=self._run, args=(fn, args))
        self.thread.start()

    def _run(self, fn, args):
        try:
            self.result = fn(*args)
        except Exception as exc:                # raised again by join()
            self.error = exc

    def join(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.result


# --- the JAX side and the one-process port step ----------------------------

def _drawn(shapes, seed, spread: bool = False):
    """Xavier-uniform kernels and zero biases of the shapes of an
    ``eval_shape``d init, drawn by numpy; with ``spread``, biases of
    0.1 N(0, 1) and layer-norm scales of 1 + 0.1 N(0, 1) instead."""
    import jax
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        shape = leaf.shape
        if path[-1].key == "scale":
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if path[-1].key != "kernel":
            return (0.1 * rng.randn(*shape) if spread
                    else np.zeros(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        fan_out = int(np.prod(shape[:-2])) * shape[-1]
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-lim, lim, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_config(train_flow: bool):
    import jax.numpy as jnp

    from sndepth_tpu.core.config import GeoNetConfig as JaxGeoNetConfig
    return JaxGeoNetConfig(batch_size=B, img_height=H, img_width=W,
                           num_scales=NUM_SCALES, compute_dtype=jnp.float32,
                           train_flow=train_flow)


def _as_torch(tree) -> dict:
    """JAX GeoNet params -> the port's state dicts by net."""
    import jax

    from sndepth_tpu_torch.utils.weights import (
        dispnet_state_dict_from_jax, flownet_state_dict_from_jax,
        posenet_state_dict_from_jax)
    carriers = {"disp_net": ("disp", dispnet_state_dict_from_jax),
                "pose_net": ("pose", posenet_state_dict_from_jax),
                "flow_net": ("flow", flownet_state_dict_from_jax)}
    return {key: carry(jax.tree_util.tree_map(np.asarray, tree[jkey]))
            for key, (jkey, carry) in carriers.items() if jkey in tree}


def _jax_params(train_flow: bool):
    """Numpy-drawn JAX GeoNet params (nothing compiled)."""
    import jax

    from sndepth_tpu.train import geonet as jgeo
    jcfg = _jax_config(train_flow)
    shapes = jax.eval_shape(lambda: jgeo.create_train_state(jcfg))
    params = _drawn(shapes.params, 0)
    if train_flow:
        params["pose"]["Conv_7"]["kernel"] *= POSE_SCALE
    return params


def _jax_case(train_flow: bool, params):
    """The JAX data-parallel step on two devices from ``params``: (its
    metrics, its parameters after Adam as the port's state dicts)."""
    import jax
    import jax.numpy as jnp

    from sndepth_tpu.parallel import mesh as jmesh
    from sndepth_tpu.train import geonet as jgeo
    jcfg = _jax_config(train_flow)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = jgeo.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            opt_state=jgeo.make_optimizer(jcfg).init(params),
                            rng=jax.random.PRNGKey(jcfg.seed))
    mesh = jmesh.make_mesh(jax.devices()[:2])
    batch = _batch(train_flow)
    state1, metrics = jmesh.make_parallel_train_step(jcfg, mesh)(
        jmesh.replicate_state(state, mesh),
        jmesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                          mesh))
    return ({k: float(v) for k, v in metrics.items()},
            _as_torch(state1.params))


def _one_process(train_flow: bool, weights: dict, batch: dict):
    from sndepth_tpu_torch.train import geonet as tgeo
    cfg = _tcfg(train_flow)
    state = tgeo.create_train_state(cfg, "cpu")
    _load(state, weights)
    metrics = tgeo.train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    return {k: float(v) for k, v in metrics.items()}, _named(state)


def _shard_mask_means(weights: dict, batch: dict) -> np.ndarray:
    """(2 * NUM_SCALES, 2): each consistency mask's mean (2 directions x
    the scales) on each shard of the stage-2 batch, from the initial
    weights."""
    from sndepth_tpu_torch.train import geonet as tgeo
    cfg = _tcfg(True)
    state = tgeo.create_train_state(cfg, "cpu")
    _load(state, weights)
    means = []

    def record(mask):
        means.append(mask.reshape(2, -1).mean(1).numpy())
        return mask.mean()
    with torch.no_grad():
        tgeo.geonet_loss(state.disp_net, state.pose_net, tgeo.preprocess_batch(
            {k: torch.from_numpy(v) for k, v in batch.items()}), cfg,
            state.flow_net, record)
    return np.stack(means)


@pytest.fixture(scope="module")
def geonet_runs(tmp_path_factory, layer_groups):
    del layer_groups                    # started first, joined later
    tmp = tmp_path_factory.mktemp("geonet_ddp")
    cases = (("stage1", False), ("stage2", True))
    params = {case: _jax_params(flow) for case, flow in cases}
    inputs = {case: {"weights": _as_torch(params[case]),
                     "batch": _batch(flow)} for case, flow in cases}
    torch.save(inputs, tmp / "inputs.pt")
    group = _Background(_run_group, _geonet_worker, 2, tmp, str(tmp))
    stage1 = _Background(_jax_case, False, params["stage1"])
    jax_runs = {"stage2": _jax_case(True, params["stage2"]),
                "stage1": stage1.join()}
    group.join()
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    shutil.rmtree(tmp)                    # ~0.8 GB of weights
    return dict(jax=jax_runs, ranks=ranks,
                single={**ranks[0]["single"], **ranks[1]["single"]},
                masks=ranks[1]["masks"], inputs=inputs)


def _params_close(got: dict, want: dict) -> None:
    n_off = n_all = 0
    assert set(got) == set(want)
    for k, p in got.items():
        diff = (p - want[k]).abs()
        assert float(diff.max()) <= 2 * LR, k
        n_off += int((diff > 2e-6).sum())
        n_all += diff.numel()
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


@pytest.mark.parametrize("case,parts,rtol", [("stage1", PARTS1, 1e-5),
                                             ("stage2", PARTS2, 2e-5)])
def test_ddp_step_loss_matches_jax_and_one_process(geonet_runs, case, parts,
                                                   rtol):
    jmet = geonet_runs["jax"][case][0]
    smet, _ = geonet_runs["single"][case]
    r0, r1 = (r[case]["metrics"] for r in geonet_runs["ranks"])
    assert r0 == r1, "the logged parts differ between the ranks"
    for key in parts:
        assert np.isfinite(r0[key]), key
        np.testing.assert_allclose(r0[key], jmet[key], rtol=rtol,
                                   err_msg=key)
        np.testing.assert_allclose(r0[key], smet[key], rtol=rtol,
                                   err_msg=key)


@pytest.mark.parametrize("case", ["stage1", "stage2"])
def test_ddp_step_params_after_adam_match_jax_and_one_process(geonet_runs,
                                                              case):
    assert all(r[case]["same_as_rank0"] for r in geonet_runs["ranks"])
    p0 = geonet_runs["ranks"][0][case]["params"]
    jparams = {f"{key}.{k}": v
               for key, sd in geonet_runs["jax"][case][1].items()
               for k, v in sd.items()}
    _params_close(p0, jparams)
    _params_close(p0, geonet_runs["single"][case][1])


def test_stage2_shards_have_different_mask_means(geonet_runs):
    """The case the global normaliser exists for: the two shards' mask
    means part (the local normaliser would change the loss by far more
    than the tolerance), and every mask is mixed on some shard."""
    masks = geonet_runs["masks"]
    assert np.abs(masks[:, 0] - masks[:, 1]).max() > 0.05, masks
    assert masks.min() < 0.99, masks


def test_nonfinite_shard_skips_the_step_on_every_rank(geonet_runs):
    """Rank 1's shard alone gives a non-finite loss: both ranks skip, with
    equal counters, and keep the initial weights."""
    for r in geonet_runs["ranks"]:
        rec = r["nonfinite"]
        assert rec["notfinite_count"] == 1 and rec["step"] == 1
        assert rec["kept_weights"] and rec["same_as_rank0"]


def test_fsdp_step_loss_matches_ddp_and_shards_the_state(geonet_runs):
    for r in geonet_runs["ranks"]:
        fs, dp = r["fsdp"], r["stage1"]
        for key in PARTS1:
            np.testing.assert_allclose(fs["metrics"][key],
                                       dp["metrics"][key], rtol=1e-6,
                                       err_msg=key)
        assert fs["notfinite_count"] == 0 and fs["step"] == 1
        assert fs["bytes"] < 0.6 * fs["full_bytes"], (fs["bytes"],
                                                      fs["full_bytes"])


# --- tensor, sequence and pipeline parallelism -------------------------------
# A 4-layer denoiser (d 64, 4 heads, feed-forward 128) with numpy-drawn JAX
# weights carried across by ``denoiser_state_dict_from_jax``; the JAX side
# is the unsharded model and its encoder layers applied in sequence.

D_MODEL, N_LAYERS = 64, 4


def _denoiser():
    from sndepth_tpu_torch.models.denoiser import Denoiser
    return Denoiser(num_layers=N_LAYERS, d_model=D_MODEL, dim_feedforward=128)


def _layer_worker(rank, world, io_dir):
    from sndepth_tpu_torch.parallel import (pipeline, sequence_parallel,
                                            tensor_parallel)
    inputs = torch.load(os.path.join(io_dir, "layers_in.pt"),
                        weights_only=True)
    out = {}
    model = _denoiser()
    model.load_state_dict(inputs["sd"])
    layers = list(model._trunk.layers)
    if world == 2:
        out["sp"], _ = sequence_parallel.run_sequence_parallel_encoder(
            layers, inputs["seq_x"])
        out["pp_2x4"], _ = pipeline.run_pipeline_denoiser(
            layers, inputs["pipe_x"], n_micro=4)
        tp_model = _denoiser()
        tp_model.load_state_dict(inputs["sd"])
        out["tp"] = tensor_parallel.run_tensor_parallel_denoiser(
            tp_model, *inputs["tp"], model_parallel=2)
        out["placements"] = {
            name: str(getattr(m.weight, "placements", "replicated"))
            for name, m in tp_model.named_modules()
            if isinstance(m, torch.nn.Linear)}
    else:
        out["pp_4x2"], _ = pipeline.run_pipeline_denoiser(
            layers, inputs["pipe_x"], n_micro=2)
    torch.save(out, os.path.join(io_dir, f"layers_w{world}_r{rank}.pt"))


@pytest.fixture(scope="module")
def layer_groups(tmp_path_factory):
    """The layers' inputs and weights, and their 2- and 4-rank groups,
    started on threads. ``geonet_runs`` asks for this fixture first, so
    that the groups run while the GeoNet group and the JAX compiles do;
    ``layer_runs`` joins them."""
    import jax

    from sndepth_tpu.models.denoiser import Denoiser
    from sndepth_tpu_torch.utils.weights import denoiser_state_dict_from_jax
    rng = np.random.RandomState(7)
    tp_in = (rng.randn(2, 4, 9).astype(np.float32),
             rng.uniform(0, 100, (2,)).astype(np.float32),
             rng.randn(2, 4, 384).astype(np.float32))
    seq_x = rng.randn(2, 16, D_MODEL).astype(np.float32)
    pipe_x = rng.randn(8, 6, D_MODEL).astype(np.float32)
    jmodel = Denoiser(num_layers=N_LAYERS, d_model=D_MODEL,
                      dim_feedforward=128)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                *tp_in))["params"]
    params = _drawn(shapes, 5, spread=True)
    sd = denoiser_state_dict_from_jax(params)
    tmp = tmp_path_factory.mktemp("layers")
    torch.save({"sd": sd, "tp": tuple(map(torch.from_numpy, tp_in)),
                "seq_x": torch.from_numpy(seq_x),
                "pipe_x": torch.from_numpy(pipe_x)}, tmp / "layers_in.pt")
    groups = [_Background(_run_group, _layer_worker, world,
                          tmp / f"w{world}", str(tmp)) for world in (2, 4)]
    yield dict(tmp=tmp, groups=groups, jmodel=jmodel, params=params, sd=sd,
               tp_in=tp_in, seq_x=seq_x, pipe_x=pipe_x)
    for group in groups:
        group.thread.join()
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def layer_runs(layer_groups):
    import jax
    import jax.numpy as jnp

    from sndepth_tpu.models.denoiser import TransformerEncoderLayer
    g = layer_groups
    params = g["params"]
    jlayer = TransformerEncoderLayer(d_model=D_MODEL, nhead=4,
                                     dim_feedforward=128)
    apply = jax.jit(lambda p, h: jlayer.apply({"params": p}, h))

    def jax_stack(x):
        h = jnp.asarray(x)
        for i in range(N_LAYERS):
            h = apply(params["TransformerEncoder_0"]
                      [f"TransformerEncoderLayer_{i}"], h)
        return np.asarray(h)

    want = {"tp": np.asarray(g["jmodel"].apply({"params": params},
                                               *g["tp_in"])),
            "sp": jax_stack(g["seq_x"]), "pp": jax_stack(g["pipe_x"])}
    for group in g["groups"]:
        group.join()
    got = {world: [torch.load(g["tmp"] / f"layers_w{world}_r{r}.pt",
                              weights_only=True) for r in range(world)]
           for world in (2, 4)}
    model = _denoiser()
    model.load_state_dict(g["sd"])
    with torch.no_grad():
        plain = {"tp": model(*map(torch.from_numpy, g["tp_in"])),
                 "sp": model._trunk(torch.from_numpy(g["seq_x"])),
                 "pp": model._trunk(torch.from_numpy(g["pipe_x"]))}
    return dict(want=want, got=got, plain=plain)


@pytest.mark.parametrize("key,world,ref", [("tp", 2, "tp"), ("sp", 2, "sp"),
                                           ("pp_2x4", 2, "pp"),
                                           ("pp_4x2", 4, "pp")])
def test_sharded_layers_match_jax_and_the_unsharded_port(layer_runs, key,
                                                         world, ref):
    """Every rank returns the whole output, equal to the JAX layers and to
    the port's unsharded model: TP at model size 2, SP over 2 shards, PP
    at (2 stages, 4 microbatches) and (4, 2)."""
    for r, out in enumerate(layer_runs["got"][world]):
        got = out[key].numpy()
        np.testing.assert_allclose(got, layer_runs["want"][ref], rtol=1e-5,
                                   atol=1e-5, err_msg=f"{key} rank {r}")
        np.testing.assert_allclose(got, layer_runs["plain"][ref].numpy(),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"{key} rank {r}")


def test_tensor_parallel_shards_the_dense_kernels_only(layer_runs):
    """The JAX rule: linear layers whose output divides the model size are
    split on their output (``Shard(0)`` DTensors); the attention output
    projection (a 3-D ``DenseGeneral`` in flax) and the 9-dim pose head
    stay replicated."""
    placements = layer_runs["got"][2][0]["placements"]
    sharded = {k for k, v in placements.items() if v == "(Shard(dim=0),)"}
    assert sharded == {"time_embed.linear.0", "time_embed.linear.2",
                       "_first", "_last.1",
                       *(f"_trunk.layers.{i}.linear{j}"
                         for i in range(N_LAYERS) for j in (1, 2))}
    assert set(placements) - sharded == {
        "_last.3", *(f"_trunk.layers.{i}.self_attn.out_proj"
                     for i in range(N_LAYERS))}
    assert all(placements[k] == "replicated"
               for k in set(placements) - sharded)
