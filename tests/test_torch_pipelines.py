"""The port's GeoNet close and prediction entry points on the CPU:
``GeoNetStage`` against the JAX stage on the same weights and batch; the
evaluation CLIs against the JAX CLIs on the same generated files, both with
``--pred_file`` and on their network paths, each side restoring the same
weights from its own checkpoint layout; the NYU reader and the savers
against the JAX package's; the code that joins the GeoNet -> NNET -> RAFT3D
prediction CLI's stages against the JAX CLI's, and the CLI at a small size;
and ``train_geonet --profile_at``.

Tolerances: the stage's disparity, depth and images 1e-5 relative by norm,
its poses 1e-4 (float32 convolutions summed in another order; the pose head
averages small values); the CLIs' metrics rtol 1e-5 (the same arithmetic in
float32, means summed in another order), DispNetS's disparities 1e-5
relative by norm. Every output is asserted finite.
"""

import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sndepth_tpu import pipelines as jpipe
from sndepth_tpu.cli import evaluate_depth as jeval_depth
from sndepth_tpu.cli import evaluate_normals as jeval_normals
from sndepth_tpu.core.config import GeoNetConfig as JaxGeoNetConfig
from sndepth_tpu.data.nyu import NYUv2Dataset as JaxNYU
from sndepth_tpu.models import nnet as jnnet
from sndepth_tpu.train import checkpoint as jckpt
from sndepth_tpu.train import geonet as jgeo
from sndepth_tpu.utils import visualize as jvis
from sndepth_tpu_torch import pipelines as tpipe
from sndepth_tpu_torch.cli import evaluate_depth, evaluate_normals
from sndepth_tpu_torch.cli import predict_raft3d, train_geonet
from sndepth_tpu_torch.core.config import GeoNetConfig
from sndepth_tpu_torch.data.nyu import NYUv2Dataset
from sndepth_tpu_torch.data.synthetic import synthetic_batches
from sndepth_tpu_torch.train import geonet as tgeo
from sndepth_tpu_torch.train import loop
from sndepth_tpu_torch.utils import visualize as tvis
from sndepth_tpu_torch.utils.threads import torch_threads
from sndepth_tpu_torch.utils.weights import (dispnet_state_dict_from_jax,
                                             nnet_state_dict_from_jax,
                                             posenet_state_dict_from_jax)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


B, H, W = 2, 32, 64


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _geonet_params(jcfg, seed):
    """JAX GeoNet params for ``jcfg``: xavier-uniform kernels and small
    biases drawn by numpy for ``jax.eval_shape`` of ``init_params``."""
    shapes = jax.eval_shape(lambda k: jgeo.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        if path[-1].key != "kernel":
            return (0.01 * rng.randn(*leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        fan_out = int(np.prod(leaf.shape[:-2])) * leaf.shape[-1]
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-lim, lim, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_geonet_stage_matches_jax():
    """Disparity, depth, poses and the scaled images of one batch, from the
    same weights."""
    jcfg = JaxGeoNetConfig(batch_size=B, img_height=H, img_width=W,
                           compute_dtype=jnp.float32)
    params = _geonet_params(jcfg, 0)
    jstage = jpipe.GeoNetStage(jcfg, params=jax.tree_util.tree_map(
        jnp.asarray, params))
    tstage = tpipe.GeoNetStage(
        GeoNetConfig(batch_size=B, img_height=H, img_width=W,
                     compute_dtype=torch.float32),
        {"disp_net": dispnet_state_dict_from_jax(params["disp"]),
         "pose_net": posenet_state_dict_from_jax(params["pose"])},
        device="cpu")
    batch = next(synthetic_batches(B, H, W, seed=4))
    want = jstage({k: jnp.asarray(v) for k, v in batch.items()})
    got = tstage(batch)
    assert _rel(got["disp"], want["disp"]) <= 1e-5
    assert _rel(got["depth"], want["depth"]) <= 1e-5
    assert _rel(got["poses"], want["poses"]) <= 1e-4
    assert _rel(got["tgt_norm"].permute(0, 2, 3, 1), want["tgt_norm"]) <= 1e-6
    assert _rel(got["src_norm"].permute(0, 2, 3, 1), want["src_norm"]) <= 1e-6


def _template(make):
    """What ``make()`` returns, with zeros for its arrays. A JAX CLI's
    eager ``init`` (one XLA compile an operation: ~8 s for GeoNet, ~70 s
    for the full-width encoder and decoder on the CPU) only makes the
    template that its restore fills; the tests make it from
    ``jax.eval_shape`` instead."""
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  jax.eval_shape(make))


def _cli_metrics(main, argv, path):
    main(argv + ["--metrics_json", path])
    with open(path) as f:
        return json.load(f)


def _assert_same_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_evaluate_depth_matches_jax_on_predictions(tmp_path):
    rng = np.random.RandomState(1)
    gts = [(rng.rand(40, 100) * 60 + 1).astype(np.float32) for _ in range(3)]
    gts[1][:5] = 0.0                                 # invalid rows
    masks = [g > 0 for g in gts]
    np.savez(tmp_path / "gt.npz", gt_depths=np.stack(gts),
             masks=np.stack(masks))
    np.savez(tmp_path / "gt_nomask.npz", gt_depths=np.stack(gts))
    np.save(tmp_path / "pred.npy",
            (rng.rand(3, 16, 40) * 0.5 + 0.01).astype(np.float32))
    for gt in ("gt.npz", "gt_nomask.npz"):
        argv = ["--gt_file", str(tmp_path / gt),
                "--pred_file", str(tmp_path / "pred.npy")]
        _assert_same_metrics(
            _cli_metrics(evaluate_depth.main, argv, str(tmp_path / "t.json")),
            _cli_metrics(jeval_depth.main, argv, str(tmp_path / "j.json")))


def test_evaluate_depth_runs_restored_dispnet(tmp_path, monkeypatch):
    """The network path against the JAX CLI's, on the same frames and
    weights: the JAX CLI restores a params checkpoint written through
    ``sndepth_tpu.train.checkpoint``, the port the ``train_geonet``
    checkpoint of a state that holds the same DispNetS, carried across by
    ``dispnet_state_dict_from_jax``."""
    rng = np.random.RandomState(2)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"{i:03d}.png")
        Image.fromarray(rng.randint(0, 256, (40, 90, 3), np.uint8)).save(p)
        paths.append(p)
    with open(tmp_path / "list.txt", "w") as f:
        f.write("\n".join(paths))
    np.savez(tmp_path / "gt.npz", gt_depths=np.stack(
        [(rng.rand(40, 90) * 60 + 1).astype(np.float32)] * 3))
    params = _geonet_params(JaxGeoNetConfig(
        img_height=H, img_width=W, compute_dtype=jnp.float32), 5)
    jckpt.save_checkpoint(str(tmp_path / "jckpt"), params, step=0)
    make = jgeo.create_train_state
    monkeypatch.setattr(jgeo, "create_train_state",
                        lambda cfg: _template(lambda: make(cfg)))
    state = tgeo.create_train_state(GeoNetConfig(
        img_height=H, img_width=W, compute_dtype=torch.float32), "cpu")
    state.disp_net.load_state_dict(dispnet_state_dict_from_jax(
        params["disp"]))
    loop.save_checkpoint(state, str(tmp_path / "tckpt"))
    argv = ["--gt_file", str(tmp_path / "gt.npz"), "--img_list",
            str(tmp_path / "list.txt"), "--img_height", str(H),
            "--img_width", str(W)]
    got = _cli_metrics(evaluate_depth.main, argv + [
        "--ckpt_dir", str(tmp_path / "tckpt"), "--device", "cpu",
        "--output_dir", str(tmp_path / "tout")], str(tmp_path / "t.json"))
    want = _cli_metrics(jeval_depth.main, argv + [
        "--ckpt_dir", str(tmp_path / "jckpt"), "--output_dir",
        str(tmp_path / "jout")], str(tmp_path / "j.json"))
    _assert_same_metrics(got, want)
    preds = np.load(tmp_path / "tout" / "predictions.npy")
    assert preds.shape == (3, H, W)
    assert _rel(preds, np.load(tmp_path / "jout" / "predictions.npy")) <= 1e-5


def _nyu_tree(root, n, h, w, seed):
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "test")
    os.makedirs(base)
    for i in range(n):
        stem = os.path.join(base, f"{i:04d}")
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
            stem + "_rgb.png")
        nrm = rng.randn(h, w, 3)
        nrm[..., 2] = np.abs(nrm[..., 2]) + 1
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        Image.fromarray(((nrm + 1) / 2 * 255).astype(np.uint8)).save(
            stem + "_norm.png")
        if i % 2 == 0:
            Image.fromarray(((rng.rand(h, w) > 0.2) * 255).astype(np.uint8)
                            ).save(stem + "_mask.png")


def test_nyu_reader_matches_jax(tmp_path):
    _nyu_tree(str(tmp_path), 2, 30, 40, 3)
    for size in ((None, None), (24, 32)):
        got, want = NYUv2Dataset(str(tmp_path), "test", *size), JaxNYU(
            str(tmp_path), "test", *size)
        assert len(got) == len(want) == 2
        for i in range(2):
            for k in ("rgb", "normals", "mask"):
                np.testing.assert_array_equal(got[i][k], want[i][k])


def test_evaluate_normals_matches_jax_on_predictions(tmp_path):
    _nyu_tree(str(tmp_path), 3, 30, 40, 4)
    rng = np.random.RandomState(5)
    preds = rng.randn(3, 24, 32, 3).astype(np.float32)
    preds[..., 2] = np.abs(preds[..., 2]) + 1
    np.save(tmp_path / "pred.npy", preds)
    argv = ["--data_dir", str(tmp_path), "--img_height", "24",
            "--img_width", "32", "--pred_file", str(tmp_path / "pred.npy"),
            "--log_file", str(tmp_path / "log.txt")]
    _assert_same_metrics(
        _cli_metrics(evaluate_normals.main, argv, str(tmp_path / "t.json")),
        _cli_metrics(jeval_normals.main, argv, str(tmp_path / "j.json")))


def _nnet_variables(h, w, seed):
    """Full-width JAX NNET (GN) params and batch_stats for ``jax.eval_shape``
    of ``init``, drawn by numpy; the normal heads get +3 toward the camera,
    as a trained decoder's normals face it (so no normal is near zero
    length, where its direction would follow the last bits)."""
    args = (jnp.zeros((1, h, w)), jnp.zeros((1, h, w, 3)),
            jnp.zeros((1, h, w, 3)), jnp.zeros((1, h, w, 1)))
    shapes = jax.eval_shape(lambda k: jnnet.NNET().init(k, *args),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        keys = [p.key for p in path]
        if keys[-1] == "kernel":
            a = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif keys[-1] == "var":
            a = 0.5 + rng.rand(*leaf.shape)
        elif keys[-1] == "scale":
            a = 1.0 + 0.1 * rng.randn(*leaf.shape)
        else:                                    # bias, mean
            a = 0.1 * rng.randn(*leaf.shape)
        if "decoder" in keys and keys[-2:] in (["Conv_1", "bias"],
                                               ["Dense_3", "bias"]):
            a[2] += 3.0
        return a.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return v["params"], v["batch_stats"]


def test_evaluate_normals_runs_restored_encoder_and_decoder(tmp_path,
                                                           monkeypatch):
    """The encoder + decoder path at full width against the JAX CLI's, on
    the same images and weights: the JAX CLI restores the converted layout
    (``{"encoder": {"params", "batch_stats"}, "decoder": {"params"}}``)
    written through ``sndepth_tpu.train.checkpoint``, the port ``nnet.pth``
    as ``nnet_state_dict_from_jax`` makes it from the same variables."""
    h, w = 64, 96
    _nyu_tree(str(tmp_path), 1, h, w, 6)
    params, stats = _nnet_variables(h, w, 1)
    jckpt.save_checkpoint(str(tmp_path / "jckpt"), {
        "encoder": {"params": params["encoder"],
                    "batch_stats": stats["encoder"]},
        "decoder": {"params": params["decoder"]}}, step=0)
    os.makedirs(tmp_path / "tckpt")
    torch.save(nnet_state_dict_from_jax(params, stats),
               tmp_path / "tckpt" / evaluate_normals.NNET_FILE)
    init = nn.Module.init
    monkeypatch.setattr(nn.Module, "init", lambda self, *a, **k: _template(
        lambda: init(self, *a, **k)))
    argv = ["--data_dir", str(tmp_path), "--img_height", str(h),
            "--img_width", str(w), "--log_file", str(tmp_path / "log.txt")]
    _assert_same_metrics(
        _cli_metrics(evaluate_normals.main, argv + [
            "--ckpt_dir", str(tmp_path / "tckpt"), "--device", "cpu"],
            str(tmp_path / "t.json")),
        _cli_metrics(jeval_normals.main, argv + [
            "--ckpt_dir", str(tmp_path / "jckpt")], str(tmp_path / "j.json")))


def test_savers_match_jax(tmp_path):
    rng = np.random.RandomState(7)
    flow = rng.randn(12, 16, 2).astype(np.float32)
    np.testing.assert_array_equal(tvis.flow_to_rgb(flow),
                                  jvis.flow_to_rgb(flow))
    np.testing.assert_array_equal(tvis.normalize01(flow),
                                  jvis.normalize01(flow))
    for name, img in (("flow", flow), ("depth", rng.rand(12, 16)),
                      ("rgb", rng.rand(12, 16, 3))):
        tvis.save_image(str(tmp_path / f"t_{name}.png"), img)
        jvis.save_image(str(tmp_path / f"j_{name}.png"), img)
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / f"t_{name}.png")),
            np.asarray(Image.open(tmp_path / f"j_{name}.png")))
    poses = rng.randn(3, 2, 6)
    tvis.pose_to_csv(poses, str(tmp_path / "t.csv"))
    jvis.pose_to_csv(poses, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


def test_predict_raft3d_writes_its_files(tmp_path):
    out = predict_raft3d.main(
        ["--synthetic", "--max_batches", "2", "--iters", "2",
         "--img_height", "64", "--img_width", "64", "--device", "cpu",
         "--out_dir", str(tmp_path)])
    assert len(out) == 2
    for i, rec in enumerate(out):
        assert rec["Ts"] == (1, 64, 64, 7) and rec["tau_phi"] == (64, 64, 6)
        for name, path in rec["paths"].items():
            assert path == str(tmp_path / f"{name}_{i}.png")
            img = np.asarray(Image.open(path))
            assert img.shape[:2] == (64, 64) and img.dtype == np.uint8


def test_predict_raft3d_joins_its_stages_as_jax_does(tmp_path, monkeypatch):
    """The code between the prediction CLI's stages against the JAX CLI's:
    on each side the three stages are stubs that record what they are
    handed and return the same numpy values in their side's layout, so
    the batches, the frames and their scaling, the depth handed to NNET,
    the clip, the intrinsics and the files written are compared without
    the nets (held against JAX in their own tests)."""
    from sndepth_tpu.cli import predict_raft3d as jpredict
    h, w, frames = 16, 24, 2
    rng = np.random.RandomState(10)

    def draw(*shape, lo=-1.0, hi=1.0):
        return (lo + (hi - lo) * rng.rand(*shape)).astype(np.float32)

    outs = [{"depth": draw(1, h, w, lo=0.5, hi=50), "tgt": draw(1, h, w, 3),
             "src": draw(1, h, w, 6),
             "refined": draw(1, h, w, 1, lo=-10, hi=100),
             "Ts": draw(1, h, w, 7), "tau_phi": draw(1, h, w, 6)}
            for _ in range(frames)]

    def stubs(seen, arr, nchw, nhwc):
        class Stage:
            def __init__(self, *args, **kwargs):
                pass

        class GeoNet(Stage):
            def __call__(self, batch):
                seen.append({k: np.asarray(v) for k, v in batch.items()})
                o = outs[len(seen) - 1]
                return {"depth": arr(o["depth"]), "tgt_norm": nchw(o["tgt"]),
                        "src_norm": nchw(o["src"])}

        class NNET(Stage):
            def __call__(self, pre_depth, rgb):
                seen[-1].update(pre_depth=np.asarray(pre_depth),
                                rgb=np.asarray(nhwc(rgb)))
                return {"depth": arr(outs[len(seen) - 1]["refined"])}

        class RAFT3D(Stage):
            def __call__(self, img1, img2, depth1, depth2, k):
                seen[-1].update(img1=np.asarray(nhwc(img1)),
                                img2=np.asarray(nhwc(img2)),
                                depth1=np.asarray(depth1),
                                depth2=np.asarray(depth2), k=np.asarray(k))
                o = outs[len(seen) - 1]
                return arr(o["Ts"]), arr(o["tau_phi"])
        return GeoNet, NNET, RAFT3D

    seen = {"jax": [], "torch": []}
    for side, mod, arr, nchw, nhwc in (
            ("jax", jpipe, jnp.asarray, jnp.asarray, lambda x: x),
            ("torch", tpipe, torch.from_numpy,
             lambda a: torch.from_numpy(a).permute(0, 3, 1, 2),
             lambda x: x.permute(0, 2, 3, 1))):
        for name, stub in zip(("GeoNetStage", "NNETStage", "RAFT3DStage"),
                              stubs(seen[side], arr, nchw, nhwc)):
            monkeypatch.setattr(mod, name, stub)
    argv = ["--synthetic", "--max_batches", str(frames), "--img_height",
            str(h), "--img_width", str(w)]
    jpredict.main(argv + ["--out_dir", str(tmp_path / "jax")])
    predict_raft3d.main(argv + ["--out_dir", str(tmp_path / "torch"),
                                "--device", "cpu"])
    assert len(seen["torch"]) == len(seen["jax"]) == frames
    for got, want in zip(seen["torch"], seen["jax"]):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for i in range(frames):
        for name in ("tau", "phi", "depth"):
            np.testing.assert_array_equal(
                np.asarray(Image.open(tmp_path / "torch" / f"{name}_{i}.png")),
                np.asarray(Image.open(tmp_path / "jax" / f"{name}_{i}.png")))


def test_train_geonet_profile_at_writes_a_trace(tmp_path, capsys):
    train_geonet.main(
        ["--max_steps", "2", "--profile_at", "2", "--batch_size", "1",
         "--img_height", "32", "--img_width", "64", "--device", "cpu",
         "--dtype", "float32", "--ckpt_dir", str(tmp_path / "ckpt"),
         "--graphs_dir", str(tmp_path / "logs")])
    trace = tmp_path / "logs" / "trace" / "step_2.json"
    assert trace.exists() and json.loads(trace.read_text())["traceEvents"]
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert json.loads(lines[0])["trace"] == str(trace)
