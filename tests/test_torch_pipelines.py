"""The port's GeoNet close and prediction entry points on the CPU:
``GeoNetStage`` against the JAX stage on the same weights and batch; the
evaluation CLIs (depth, normals, motion) against the JAX CLIs on the same
generated files, both with ``--pred_file`` and on their network paths, each
side restoring the same weights from its own checkpoint layout;
``predict_motion`` against the JAX CLI; the NYU reader and the savers
against the JAX package's; the code that joins the stages of the GeoNet ->
NNET -> RAFT3D and of the fused GeoNet -> NNET -> flow -> motion
prediction CLIs (rigid, RAFT2D and RAFT2D-Large flow) against the JAX
CLIs', both CLIs at a small size, the fused one also serving a torchvision
RAFT-Large checkpoint;
``train_geonet --profile_at``; ``train_motion`` and ``train_nnet`` for two
steps, their checkpoints restored.

Tolerances: the stage's disparity, depth and images 1e-5 relative by norm,
its poses 1e-4 (float32 convolutions summed in another order; the pose head
averages small values); the CLIs' metrics rtol 1e-5 (the same arithmetic in
float32, means summed in another order), DispNetS's disparities 1e-5
relative by norm; the motion class maps and PNGs equal; in the fused
prediction the images handed to the motion stage within 1e-5 (the rigid
flow's float32 arithmetic in another order, through the HSV colouring) and
the flow PNG within one level. Every output is asserted finite.
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
from sndepth_tpu.cli import evaluate_motion as jeval_motion
from sndepth_tpu.cli import evaluate_normals as jeval_normals
from sndepth_tpu.cli import predict as jpredict
from sndepth_tpu.cli import predict_motion as jpredict_motion
from sndepth_tpu.core.config import GeoNetConfig as JaxGeoNetConfig
from sndepth_tpu.data.nyu import NYUv2Dataset as JaxNYU
from sndepth_tpu.models import motionseg as jm
from sndepth_tpu.models import nnet as jnnet
from sndepth_tpu.train import checkpoint as jckpt
from sndepth_tpu.train import geonet as jgeo
from sndepth_tpu.train import motion as jmt
from sndepth_tpu.utils import visualize as jvis
from sndepth_tpu_torch import pipelines as tpipe
from sndepth_tpu_torch.cli import evaluate_depth, evaluate_normals
from sndepth_tpu_torch.cli import evaluate_motion, predict, predict_motion
from sndepth_tpu_torch.cli import predict_raft3d, train_geonet
from sndepth_tpu_torch.cli import train_motion, train_nnet
from sndepth_tpu_torch.core.config import GeoNetConfig
from sndepth_tpu_torch.data.nyu import NYUv2Dataset
from sndepth_tpu_torch.data.synthetic import synthetic_batches
from sndepth_tpu_torch.models.motionseg import MotionFusionNet
from sndepth_tpu_torch.train import geonet as tgeo
from sndepth_tpu_torch.train import loop
from sndepth_tpu_torch.train import motion as tmt
from sndepth_tpu_torch.train import nnet as tnt
from sndepth_tpu_torch.utils import visualize as tvis
from sndepth_tpu_torch.utils.threads import torch_threads
from sndepth_tpu_torch.utils.weights import (dispnet_state_dict_from_jax,
                                             motionfusion_state_dict_from_jax,
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


# --- motion segmentation and the fused prediction --------------------------

MH, MW = 32, 64


def _motion_tree(root, n, h, w, seed):
    rng = np.random.RandomState(seed)
    for sub in ("image", "flow", "label"):
        os.makedirs(os.path.join(root, "val", sub))
    for i in range(n):
        for sub in ("image", "flow"):
            Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
                os.path.join(root, "val", sub, f"{i:06d}.png"))
        label = np.zeros((h, w, 3), np.uint8)
        label[..., 0] = 100 * rng.randint(0, 3, (h, w))
        Image.fromarray(label).save(
            os.path.join(root, "val", "label", f"{i:06d}.png"))


@pytest.fixture(scope="module")
def motion_ckpts(tmp_path_factory):
    """Full-width MotionFusionNet variables drawn by numpy for
    ``jax.eval_shape`` of ``init``, saved for the JAX CLIs through
    ``sndepth_tpu.train.checkpoint`` as a train state (its optimizer state
    empty: the CLIs restore into a template of that structure) and for the
    port as ``train_motion`` writes them (``motion.pth``). Returns the two
    directories and the template."""
    x = jnp.zeros((1, MH, MW, 3))
    shapes = jax.eval_shape(lambda k: jm.MotionFusionNet().init(k, x, x),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(20)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            a = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "var":
            a = 0.5 + rng.rand(*leaf.shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.randn(*leaf.shape)
        else:                                    # bias, mean
            a = 0.1 * rng.randn(*leaf.shape)
        return a.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)

    def state(tree):
        return jmt.MotionTrainState(step=np.zeros((), np.int32),
                                    params=tree["params"],
                                    batch_stats=tree["batch_stats"],
                                    opt_state=())

    root = tmp_path_factory.mktemp("motion_ckpts")
    jckpt.save_checkpoint(str(root / "jax"), state(v), step=0)
    os.makedirs(root / "torch")
    torch.save(motionfusion_state_dict_from_jax(v["params"],
                                                v["batch_stats"]),
               root / "torch" / loop.MOTION_MODEL_FILE)
    template = state(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    return str(root / "jax"), str(root / "torch"), template


def _motion_template(monkeypatch, template):
    """The JAX CLIs' ``init_motion_state`` (a jitted full-width init) only
    makes the template their restore fills: hand them the template."""
    monkeypatch.setattr(jmt, "init_motion_state",
                        lambda *args, **kwargs: template)


def test_evaluate_motion_matches_jax(tmp_path, motion_ckpts, monkeypatch):
    """Four validation samples in batches of two, the same weights on both
    sides: the mean of the batches' mIoU in ``--metrics_json``."""
    jdir, tdir, template = motion_ckpts
    _motion_tree(str(tmp_path), 4, MH, MW, 21)
    _motion_template(monkeypatch, template)
    argv = ["--data_dir", str(tmp_path), "--batch_size", "2"]
    got = _cli_metrics(evaluate_motion.main, argv + [
        "--ckpt_dir", tdir, "--device", "cpu"], str(tmp_path / "t.json"))
    want = _cli_metrics(jeval_motion.main, argv + ["--ckpt_dir", jdir],
                        str(tmp_path / "j.json"))
    assert set(got) == {"miou"} and 0 < got["miou"] <= 1
    _assert_same_metrics(got, want)


def test_predict_motion_matches_jax(tmp_path, motion_ckpts, monkeypatch,
                                    capsys):
    """A 30x60 image and flow image, padded to 32x64: the same overlay PNG
    and the same class histogram line."""
    jdir, tdir, template = motion_ckpts
    _motion_template(monkeypatch, template)
    rng = np.random.RandomState(22)
    for name in ("image", "flow"):
        Image.fromarray(rng.randint(0, 256, (30, 60, 3), np.uint8)).save(
            tmp_path / f"{name}.png")
    args = [str(tmp_path / "image.png"), str(tmp_path / "flow.png")]
    pred = predict_motion.main(args + ["--ckpt_dir", tdir, "--out", str(
        tmp_path / "t.png"), "--device", "cpu"])
    t_line = capsys.readouterr().out.strip().splitlines()[-1]
    jpredict_motion.main(args + ["--ckpt_dir", jdir, "--out",
                                 str(tmp_path / "j.png")])
    j_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert pred.shape == (30, 60) and set(np.unique(pred)) <= {0, 1, 2}
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))
    assert t_line.split(";")[1] == j_line.split(";")[1]


def test_motion_weights_load_from_a_reference_state_dict(tmp_path,
                                                         motion_ckpts):
    """``--ckpt_dir`` also takes a file: a state dict in the reference's
    names, with DataParallel's ``module.`` prefixes."""
    sd = torch.load(os.path.join(motion_ckpts[1], loop.MOTION_MODEL_FILE),
                    weights_only=True)
    torch.save({"module." + k: v for k, v in sd.items()},
               tmp_path / "best.pt")
    got = loop.load_motion_weights(str(tmp_path / "best.pt"))
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def _kitti_testing_tree(root, frames, seed):
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "testing", "seq"))
    os.makedirs(os.path.join(root, "testing", "calib_cam_to_cam"))
    for i in range(frames):
        Image.fromarray(rng.randint(0, 256, (40, 70, 3), np.uint8)).save(
            os.path.join(root, "testing", "seq", f"{i:06d}.png"))
        with open(os.path.join(root, "testing", "calib_cam_to_cam",
                               f"{i:06d}.txt"), "w") as f:
            f.write("K_02: 50 0 32 0 50 20 0 0 1\n")


@pytest.mark.parametrize("source", ["synthetic", "testing_tree"])
def test_predict_joins_its_stages_as_jax_does(tmp_path, monkeypatch,
                                              source):
    """The code between the fused prediction CLI's stages against the JAX
    CLI's: on each side GeoNet, NNET and the motion stage are stubs that
    record what they are handed and return the same numpy values in their
    side's layout; the rigid flow and its colouring are each side's own.
    On the synthetic stream the batch's 3x3 intrinsics are used, on a
    ``testing/seq`` tree (4-vector intrinsics) a K made from the image
    size. Compared: the batches, the depth and image NNET gets, the image
    and flow colouring the motion stage gets, the PNGs and ``poses.csv``
    (the last batch's poses)."""
    h, w = 16, 24
    rng = np.random.RandomState(23)
    argv = ["--img_height", str(h), "--img_width", str(w)]
    if source == "synthetic":
        argv += ["--synthetic", "--max_batches", "2"]
    else:
        _kitti_testing_tree(str(tmp_path / "data"), 2, 24)
        argv += ["--root", str(tmp_path / "data")]

    def draw(*shape, lo=-1.0, hi=1.0):
        return (lo + (hi - lo) * rng.rand(*shape)).astype(np.float32)

    outs = [{"depth": draw(1, h, w, lo=1.0, hi=30), "tgt": draw(1, h, w, 3),
             "src": draw(1, h, w, 6), "poses": draw(1, 2, 6, lo=-0.1,
                                                     hi=0.1),
             "refined": draw(1, h, w, 1, lo=1.0, hi=20),
             "normals": draw(1, h, w, 3),
             "seg": rng.randint(0, 3, (1, h, w))} for _ in range(2)]

    def stubs(seen, arr, nchw, nhwc):
        class Stage:
            def __init__(self, *args, **kwargs):
                pass

        class GeoNet(Stage):
            def __call__(self, batch):
                seen.append({k: np.asarray(v) for k, v in batch.items()})
                o = outs[len(seen) - 1]
                return {"depth": arr(o["depth"]), "tgt_norm": nchw(o["tgt"]),
                        "src_norm": nchw(o["src"]), "poses": arr(o["poses"])}

        class NNET(Stage):
            def __call__(self, pre_depth, rgb):
                seen[-1].update(pre_depth=np.asarray(pre_depth),
                                rgb=np.asarray(nhwc(rgb)))
                o = outs[len(seen) - 1]
                return {"depth": arr(o["refined"]),
                        "normals": arr(o["normals"])}

        class Motion(Stage):
            def __call__(self, image01, flow_rgb):
                seen[-1].update(image01=np.asarray(nhwc(image01)),
                                flow_rgb=np.asarray(nhwc(flow_rgb)))
                return arr(outs[len(seen) - 1]["seg"])
        return GeoNet, NNET, Motion

    seen = {"jax": [], "torch": []}
    for side, mod, arr, nchw, nhwc in (
            ("jax", jpipe, jnp.asarray, jnp.asarray, lambda x: x),
            ("torch", tpipe, torch.from_numpy,
             lambda a: torch.from_numpy(a).permute(0, 3, 1, 2),
             lambda x: x.permute(0, 2, 3, 1))):
        for name, stub in zip(("GeoNetStage", "NNETStage", "MotionStage"),
                              stubs(seen[side], arr, nchw, nhwc)):
            monkeypatch.setattr(mod, name, stub)
    jpredict.main(argv + ["--out_dir", str(tmp_path / "jax")])
    predict.main(argv + ["--out_dir", str(tmp_path / "torch"),
                         "--device", "cpu"])
    assert len(seen["torch"]) == len(seen["jax"]) == 2
    for got, want in zip(seen["torch"], seen["jax"]):
        assert set(got) == set(want)
        for k in want:
            if k == "flow_rgb":
                np.testing.assert_allclose(got[k], want[k], atol=1e-5)
                assert want[k].std() > 0.05
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for i in range(2):
        for name in ("depth", "norm", "seg", "flow"):
            a, b = (np.asarray(Image.open(tmp_path / side / f"{name}_{i}.png"),
                               np.int32) for side in ("torch", "jax"))
            assert np.abs(a - b).max() <= (1 if name == "flow" else 0), name
    assert ((tmp_path / "torch" / "poses.csv").read_text()
            == (tmp_path / "jax" / "poses.csv").read_text())


def test_predict_writes_its_files(tmp_path):
    """GeoNet, NNET, the rigid flow and MotionFusionNet at full width on
    the CPU at 64x64, two synthetic batches."""
    out = predict.main(["--synthetic", "--max_batches", "2",
                        "--img_height", "64", "--img_width", "64",
                        "--device", "cpu", "--out_dir", str(tmp_path)])
    assert len(out) == 2
    for i, rec in enumerate(out):
        assert rec["seg"].shape == (1, 64, 64)
        assert set(np.unique(rec["seg"])) <= {0, 1, 2}
        for name, path in rec["paths"][0].items():
            assert path == str(tmp_path / f"{name}_{i}.png")
            img = np.asarray(Image.open(path))
            assert img.shape[:2] == (64, 64) and img.dtype == np.uint8
    rows = (tmp_path / "poses.csv").read_text().strip().splitlines()
    assert rows[0].startswith("source_index") and len(rows) == 3
    assert all(np.isfinite(float(x)) for r in rows[1:]
               for x in r.split(","))


@pytest.mark.parametrize("source", ["raft2d", "raft2d_large"])
def test_predict_raft2d_flow_joins_as_jax_does(tmp_path, monkeypatch,
                                               source):
    """``--flow_source raft2d|raft2d_large`` against the JAX CLI, every
    stage a stub on each side that records what it is handed and returns
    the same numpy values: the flow stage is built with the same
    architecture and iterations and gets the target and the second source
    frame in [0, 1]; its flow, coloured, reaches the motion stage; the PNGs
    are equal."""
    h, w = 16, 24
    rng = np.random.RandomState(25)
    argv = ["--img_height", str(h), "--img_width", str(w), "--synthetic",
            "--max_batches", "2", "--flow_source", source,
            "--raft2d_iters", "3"]
    outs = [{"depth": (1 + 9 * rng.rand(1, h, w)).astype(np.float32),
             "tgt": rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32),
             "src": rng.uniform(-1, 1, (1, h, w, 6)).astype(np.float32),
             "poses": rng.uniform(-.1, .1, (1, 2, 6)).astype(np.float32),
             "refined": (1 + rng.rand(1, h, w, 1)).astype(np.float32),
             "normals": rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32),
             "flow": (5 * rng.randn(1, h, w, 2)).astype(np.float32),
             "seg": rng.randint(0, 3, (1, h, w))} for _ in range(2)]
    seen = {"jax": [], "torch": []}
    for side, mod, arr, nchw, nhwc in (
            ("jax", jpipe, jnp.asarray, jnp.asarray, lambda x: x),
            ("torch", tpipe, torch.from_numpy,
             lambda a: torch.from_numpy(a).permute(0, 3, 1, 2),
             lambda x: x.permute(0, 2, 3, 1))):
        rec = seen[side]

        class Stage:
            def __init__(self, *args, rec=rec, **kwargs):
                if "arch" in kwargs:
                    rec.append({"arch": kwargs["arch"],
                                "iters": kwargs["iters"]})

        def call(name, fn):
            return type(name, (Stage,), {"__call__": fn})

        def geonet(self, batch, rec=rec, arr=arr, nchw=nchw):
            rec.append({})
            o = outs[len(rec) - 2]
            return {"depth": arr(o["depth"]), "tgt_norm": nchw(o["tgt"]),
                    "src_norm": nchw(o["src"]), "poses": arr(o["poses"])}

        def nnet(self, pre_depth, rgb, rec=rec, arr=arr):
            o = outs[len(rec) - 2]
            return {"depth": arr(o["refined"]), "normals": arr(o["normals"])}

        def flow(self, img1, img2, rec=rec, arr=arr, nhwc=nhwc):
            rec[-1].update(img1=np.asarray(nhwc(img1)),
                           img2=np.asarray(nhwc(img2)))
            return arr(outs[len(rec) - 2]["flow"])

        def motion(self, image01, flow_rgb, rec=rec, arr=arr, nhwc=nhwc):
            rec[-1].update(flow_rgb=np.asarray(nhwc(flow_rgb)))
            return arr(outs[len(rec) - 2]["seg"])

        for name, fn in (("GeoNetStage", geonet), ("NNETStage", nnet),
                         ("Raft2DFlowStage", flow), ("MotionStage", motion)):
            monkeypatch.setattr(mod, name, call(name, fn))
    jpredict.main(argv + ["--out_dir", str(tmp_path / "jax")])
    predict.main(argv + ["--out_dir", str(tmp_path / "torch"),
                         "--device", "cpu"])
    assert seen["torch"][0] == seen["jax"][0] == {
        "arch": "large" if source == "raft2d_large" else "native",
        "iters": 3}
    assert len(seen["torch"]) == len(seen["jax"]) == 3
    for i, (got, want) in enumerate(zip(seen["torch"][1:], seen["jax"][1:])):
        assert set(got) == set(want) == {"img1", "img2", "flow_rgb"}
        np.testing.assert_array_equal(got["img1"],
                                      (outs[i]["tgt"] + 1.0) * 0.5)
        np.testing.assert_array_equal(got["img2"],
                                      (outs[i]["src"][..., 3:] + 1.0) * 0.5)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for name in ("depth", "norm", "seg", "flow"):
            a, b = (np.asarray(Image.open(tmp_path / side / f"{name}_{i}.png"))
                    for side in ("torch", "jax"))
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_predict_raft2d_large_serves_a_torchvision_checkpoint(tmp_path):
    """The whole CLI on the CPU at 64x64 with ``--flow_source raft2d_large``
    and a ``--raft2d_ckpt`` written from the port's own state_dict in
    torchvision's layout (under ``"model"``, with ``module.`` prefixes):
    the flow it colours is the flow of a ``Raft2DFlowStage`` holding those
    weights; without ``raft2d_large`` the checkpoint is refused."""
    from sndepth_tpu_torch.models.raft2d import RAFT2DLarge
    from sndepth_tpu_torch.models.raft3d import init_weights
    model = RAFT2DLarge()
    init_weights(model, torch.Generator().manual_seed(3))
    path = tmp_path / "raft_large.pth"
    torch.save({"model": {"module." + k: v
                          for k, v in model.state_dict().items()}}, path)
    argv = ["--synthetic", "--max_batches", "1", "--img_height", "64",
            "--img_width", "64", "--device", "cpu", "--raft2d_iters", "2",
            "--raft2d_ckpt", str(path)]
    with pytest.raises(SystemExit) as exc:
        predict.main(argv + ["--flow_source", "raft2d"])
    assert exc.value.code != 0
    out = predict.main(argv + ["--flow_source", "raft2d_large",
                               "--out_dir", str(tmp_path / "out")])
    assert out[0]["seg"].shape == (1, 64, 64)
    batch = next(synthetic_batches(1, 64, 64))
    g = tpipe.GeoNetStage(GeoNetConfig(batch_size=1, img_height=64,
                                       img_width=64,
                                       compute_dtype=torch.float32),
                          device="cpu")(batch)
    stage = tpipe.Raft2DFlowStage(model.state_dict(), iters=2, arch="large",
                                  device="cpu")
    flow = stage((g["tgt_norm"] + 1) * 0.5, (g["src_norm"][:, 3:] + 1) * 0.5)
    assert flow.shape == (1, 64, 64, 2) and torch.isfinite(flow).all()
    tvis.save_image(str(tmp_path / "want.png"), flow[0].numpy())
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "out" / "flow_0.png")),
        np.asarray(Image.open(tmp_path / "want.png")))


@pytest.mark.parametrize("source", ["synthetic", "files"])
def test_demo_joins_as_jax_does(tmp_path, monkeypatch, source):
    """The RAFT3D demo against the JAX demo, RAFT3D a stub on each side that
    records what it is handed and returns the same tau / phi: the synthetic
    pair, or a png pair with pfm depths (37x50, edge padded to 40x56), the
    intrinsics, the iterations, and the saved panel, equal bit for bit."""
    from sndepth_tpu.cli import demo as jdemo
    from sndepth_tpu.data import frame_codecs as jcodecs
    from sndepth_tpu_torch.cli import demo
    rng = np.random.RandomState(26)
    argv = ["--iters", "3"]
    if source == "files":
        for i in (1, 2):
            Image.fromarray(rng.randint(0, 256, (37, 50, 3), np.uint8)).save(
                tmp_path / f"im{i}.png")
            jcodecs.write_pfm(str(tmp_path / f"d{i}.pfm"),
                              (1 + 5 * rng.rand(37, 50)).astype(np.float32))
            argv += [f"--image{i}", str(tmp_path / f"im{i}.png"),
                     f"--depth{i}", str(tmp_path / f"d{i}.pfm")]
    hw = (40, 56) if source == "files" else (64, 96)
    tau_phi = rng.randn(1, *hw, 6).astype(np.float32)
    seen = {}
    for side, mod, arr, nhwc in (
            ("jax", jpipe, jnp.asarray, lambda x: x),
            ("torch", tpipe, torch.from_numpy,
             lambda x: x.permute(0, 2, 3, 1))):
        class Stage:
            def __init__(self, iters, side=side, **kwargs):
                seen[side] = {"iters": iters}

            def __call__(self, img1, img2, d1, d2, k, side=side, arr=arr,
                         nhwc=nhwc):
                seen[side].update(img1=np.asarray(nhwc(img1)),
                                  img2=np.asarray(nhwc(img2)),
                                  d1=np.asarray(d1), d2=np.asarray(d2),
                                  k=np.asarray(k))
                return None, arr(tau_phi)

        monkeypatch.setattr(mod, "RAFT3DStage", Stage)
    jdemo.main(argv + ["--out", str(tmp_path / "jax.png")])
    out = demo.main(argv + ["--out", str(tmp_path / "torch.png"),
                            "--device", "cpu"])
    assert set(seen["torch"]) == set(seen["jax"])
    for k, want in seen["jax"].items():
        np.testing.assert_array_equal(seen["torch"][k], want, err_msg=k)
    assert seen["torch"]["img1"].shape == (1, *hw, 3)
    np.testing.assert_array_equal(out["tau_phi"], tau_phi[0])
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "torch.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))


def test_demo_runs_raft3d_on_the_cpu(tmp_path):
    """The demo's synthetic pair through the port's RAFT3D at full width
    on the CPU, two iterations: a finite field and the 64x192 panel."""
    from sndepth_tpu_torch.cli import demo
    out = demo.main(["--iters", "2", "--device", "cpu",
                     "--out", str(tmp_path / "panel.png")])
    assert out["tau_phi"].shape == (64, 96, 6)
    assert np.isfinite(out["tau_phi"]).all()
    panel = np.asarray(Image.open(tmp_path / "panel.png"))
    assert panel.shape == (64, 192, 3) and panel.dtype == np.uint8


def _assert_same_optimizer(got, want):
    got, want = got.state_dict(), want.state_dict()
    assert got["param_groups"] == want["param_groups"]
    assert set(got["state"]) == set(want["state"]) and want["state"]
    for i, moments in want["state"].items():
        for k, v in moments.items():
            assert torch.equal(got["state"][i][k], v), (i, k)


def test_train_motion_writes_a_checkpoint_that_restores(tmp_path):
    """Two float32 steps on the synthetic stream, logged each step; the
    checkpoint restores the model, Adam's moments and the step."""
    state, records = train_motion.main(
        ["--max_steps", "2", "--batch_size", "1", "--height", str(MH),
         "--width", str(MW), "--log_every", "1", "--dtype", "f32",
         "--data_dir", str(tmp_path / "none"), "--ckpt_dir",
         str(tmp_path / "ckpt"), "--device", "cpu"])
    assert [r["step"] for r in records] == [1, 2] and state.step == 2
    assert all(np.isfinite(r["loss"]) and 0 <= r["pixel_acc"] <= 1
               for r in records)
    fresh = tmt.create_train_state(MotionFusionNet(), "cpu")
    loop.restore_motion_checkpoint(fresh, str(tmp_path / "ckpt"))
    assert fresh.step == 2
    for (name, a), b in zip(state.model.state_dict().items(),
                            fresh.model.state_dict().values()):
        assert torch.equal(a, b), name
    _assert_same_optimizer(fresh.optimizer, state.optimizer)


def test_train_nnet_writes_a_checkpoint_that_restores_and_serves(tmp_path):
    """Two steps on the synthetic stream; the checkpoint restores the
    model, AdamW's moments, the step and the sampler's generator, and its
    ``nnet.pth`` serves ``evaluate_normals --ckpt_dir``."""
    state, records = train_nnet.main(
        ["--max_steps", "2", "--batch_size", "1", "--img_height", str(MH),
         "--img_width", str(MW), "--log_every", "1", "--ckpt_dir",
         str(tmp_path / "ckpt"), "--device", "cpu"])
    assert [r["step"] for r in records] == [1, 2] and state.step == 2
    assert all(np.isfinite(r["loss"]) for r in records)
    fresh = tnt.create_train_state(tnt.NormalNet(), "cpu", seed=1)
    loop.restore_nnet_checkpoint(fresh, str(tmp_path / "ckpt"))
    assert fresh.step == 2
    assert torch.equal(fresh.generator.get_state(),
                       state.generator.get_state())
    for (name, a), b in zip(state.model.state_dict().items(),
                            fresh.model.state_dict().values()):
        assert torch.equal(a, b), name
    _assert_same_optimizer(fresh.optimizer, state.optimizer)
    _nyu_tree(str(tmp_path / "nyu"), 1, MH, MW, 25)
    metrics = evaluate_normals.main([
        "--data_dir", str(tmp_path / "nyu"), "--img_height", str(MH),
        "--img_width", str(MW), "--ckpt_dir", str(tmp_path / "ckpt"),
        "--device", "cpu", "--log_file", str(tmp_path / "log.txt")])
    assert all(np.isfinite(v) for v in metrics.values())


# --- UniAD tracking: TrackStage and predict_vae_uniad ---------------------

def test_track_stage_matches_jax(monkeypatch):
    """``TrackStage`` against the JAX stage for two chained frames on the
    CLI's single camera: the JAX stage built with parameters from
    ``jax.eval_shape`` and numpy (its flax ``init`` replaced while it is
    built, an eager UniAD init takes a minute), carried across through
    ``uniad_state_dict_from_jax``, ``vit_state_dict_from_jax`` and
    ``denoiser_state_dict_from_jax``; the track state, the detections and
    the denoised poses within 1e-4 by norm, the track ids equal."""
    from test_torch_uniad import _fill
    from sndepth_tpu_torch.utils.weights import (denoiser_state_dict_from_jax,
                                                 uniad_state_dict_from_jax,
                                                 vit_state_dict_from_jax)
    real_init = nn.Module.init
    seeds = iter(range(30, 40))

    def init(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(lambda k: real_init(self, k, *args, **kwargs),
                                rngs)
        return {"params": _fill(shapes["params"], next(seeds))}

    monkeypatch.setattr(nn.Module, "init", init)
    jstage = jpipe.TrackStage(num_cams=1, image_hw=(64, 64), vit_depth=1)
    monkeypatch.undo()
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    sds = {"track": uniad_state_dict_from_jax(
               to_np(jstage.track_vars["params"]), (1, 1, 1, 1)),
           "features": {f"net.{k}": v for k, v in vit_state_dict_from_jax(
               to_np(jstage.feat_vars["params"]["net"])).items()},
           "denoiser": denoiser_state_dict_from_jax(
               to_np(jstage.denoiser_vars["params"]))}
    stage = tpipe.TrackStage(num_cams=1, image_hw=(64, 64), vit_depth=1,
                             state_dicts=sds, device="cpu")
    rng = np.random.RandomState(31)
    jst, st = jstage.init_state(), stage.init_state()
    for _ in range(2):
        rgb = rng.rand(1, 64, 64, 3).astype(np.float32)
        jst, jres, jposes = jstage(jnp.asarray(rgb)[None],
                                   jnp.eye(4)[None, None], jst,
                                   jnp.asarray(rgb))
        trgb = torch.from_numpy(rgb).permute(0, 3, 1, 2)
        st, res, poses = stage(trgb[None], torch.eye(4)[None, None], st,
                               trgb)
        assert _rel(st.prev_bev, jst.prev_bev) < 1e-4
        assert _rel(st.tracks.query, jst.tracks.query) < 1e-4
        assert _rel(res["scores"], jres["scores"]) < 1e-4
        assert _rel(res["bboxes"], jres["bboxes"]) < 1e-4
        np.testing.assert_array_equal(st.tracks.obj_idxes.numpy(),
                                      np.asarray(jst.tracks.obj_idxes))
        assert _rel(poses, jposes) < 1e-4


def test_predict_vae_uniad_joins_its_stages_as_jax_does(tmp_path,
                                                        monkeypatch):
    """``predict_vae_uniad`` against the JAX CLI, every stage a stub that
    records what it is handed and returns the same numpy values: NNET gets
    GeoNet's depth and the image in [0, 1], the VAE that image and NNET's
    refined depth, the track stage the image as one camera, the identity
    ``lidar2img``, the carried state and the image for its features; the
    saved boxes are equal."""
    from sndepth_tpu.cli import predict_vae_uniad as jcli
    from sndepth_tpu_torch.cli import predict_vae_uniad
    h, w = 16, 24
    rng = np.random.RandomState(32)
    outs = [{"depth": (1 + rng.rand(1, h, w)).astype(np.float32),
             "tgt": rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32),
             "refined": (1 + rng.rand(1, h, w, 1)).astype(np.float32),
             "mean": rng.randn(1, 2, 3, 4).astype(np.float32),
             "boxes": rng.randn(7, 9).astype(np.float32),
             "obj": rng.randint(-1, 3, 7).astype(np.int32)}
            for _ in range(2)]
    seen = {"jax": [], "torch": []}
    for side, mod, arr, nchw, nhwc in (
            ("jax", jpipe, jnp.asarray, jnp.asarray, lambda x: x),
            ("torch", tpipe, torch.from_numpy,
             lambda a: torch.from_numpy(a).permute(0, 3, 1, 2),
             lambda x: x.permute(0, 2, 3, 1))):
        rec = seen[side]

        class Stage:
            def __init__(self, *args, **kwargs):
                self.kwargs = kwargs

        class GeoNet(Stage):
            def __call__(self, batch, rec=rec, arr=arr, nchw=nchw):
                rec.append({})
                o = outs[len(rec) - 1]
                return {"depth": arr(o["depth"]), "tgt_norm": nchw(o["tgt"])}

        class NNET(Stage):
            def __call__(self, pre_depth, rgb, rec=rec, arr=arr, nhwc=nhwc):
                rec[-1].update(pre_depth=np.asarray(pre_depth),
                               rgb=np.asarray(nhwc(rgb)))
                return {"depth": arr(outs[len(rec) - 1]["refined"])}

        class VAE(Stage):
            def __call__(self, rgb01, depth, rec=rec, arr=arr, nhwc=nhwc):
                rec[-1].update(vae_rgb=np.asarray(nhwc(rgb01)),
                               vae_depth=np.asarray(depth))
                m = arr(outs[len(rec) - 1]["mean"])
                return m, m

        class State:
            def __init__(self, obj, t):
                self.tracks = type("T", (), {"obj_idxes": obj})()
                self.t = t

        class Track(Stage):
            def init_state(self, arr=arr):
                return State(arr(np.full(7, -1, np.int32)), -1)

            def __call__(self, imgs, l2i, state, rgb, rec=rec, arr=arr,
                         nhwc=nhwc):
                o = outs[len(rec) - 1]
                rec[-1].update(track_imgs=np.asarray(nhwc(imgs[0]))[None],
                               l2i=np.asarray(l2i), state_t=state.t,
                               track_rgb=np.asarray(nhwc(rgb)),
                               num_cams=self.kwargs["num_cams"],
                               image_hw=tuple(self.kwargs["image_hw"]))
                return (State(arr(o["obj"]), state.t + 1),
                        {"bboxes": arr(o["boxes"])}, arr(o["boxes"]))

        for name, stub in (("GeoNetStage", GeoNet), ("NNETStage", NNET),
                           ("VAEStage", VAE), ("TrackStage", Track)):
            monkeypatch.setattr(mod, name, stub)
    argv = ["--img_height", str(h), "--img_width", str(w), "--frames", "2"]
    jcli.main(argv + ["--out_dir", str(tmp_path / "jax")])
    out = predict_vae_uniad.main(argv + ["--out_dir", str(tmp_path / "torch"),
                                         "--device", "cpu"])
    assert len(out) == len(seen["jax"]) == len(seen["torch"]) == 2
    for i, (got, want) in enumerate(zip(seen["torch"], seen["jax"])):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(
            np.load(tmp_path / "torch" / f"track_boxes_{i}.npy"),
            np.load(tmp_path / "jax" / f"track_boxes_{i}.npy"))
        assert out[i]["active_tracks"] == int((outs[i]["obj"] >= 0).sum())


def test_predict_vae_uniad_runs_on_the_cpu(tmp_path):
    """The whole pipeline at the JAX CLI's 64x64 for two frames: finite
    track boxes (32, 9), the poses (1, 32, 9)."""
    from sndepth_tpu_torch.cli import predict_vae_uniad
    out = predict_vae_uniad.main(["--frames", "2", "--out_dir", str(tmp_path),
                                  "--device", "cpu"])
    for rec in out:
        boxes = np.load(rec["path"])
        assert boxes.shape == (32, 9) and np.isfinite(boxes).all()
        assert rec["poses_shape"] == (1, 32, 9)
        assert rec["latent_shape"] == (1, 8, 8, 4)


# --- the alternate disparity nets and the parity report --------------------

def _alt_params(shapes, seed):
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            lim = np.sqrt(6.0 / (np.prod(leaf.shape[:-1])
                                 + np.prod(leaf.shape[:-2]) * leaf.shape[-1]))
            return rng.uniform(-lim, lim, leaf.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_dispnet_and_dispunet_match_jax():
    """``models/dispnet_alt`` against the JAX nets from the same numpy
    weights, float32; DispUNet with the bottleneck noise drawn on the JAX
    side (``jax.random.normal`` of the rng it is given) handed across."""
    from sndepth_tpu.models import dispnet_alt as jalt
    from sndepth_tpu_torch.models import dispnet_alt as talt
    from sndepth_tpu_torch.utils.weights import (
        dispnet_alt_state_dict_from_jax, dispunet_state_dict_from_jax)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jnet = jalt.DispNet()
    params = _alt_params(jax.eval_shape(
        lambda: jnet.init(jax.random.PRNGKey(0), x))["params"], 1)
    want = jax.jit(jnet.apply)({"params": params}, x)
    tnet = talt.DispNet()
    tnet.load_state_dict(dispnet_alt_state_dict_from_jax(params))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-5, atol=1e-5)

    junet = jalt.DispUNet(base=8, num_downs=4)
    key = jax.random.PRNGKey(3)
    xs = x[:, :32, :32]
    params = _alt_params(jax.eval_shape(
        lambda: junet.init(jax.random.PRNGKey(0), xs))["params"], 2)
    apply = jax.jit(junet.apply)
    want = np.asarray(apply({"params": params}, xs, key))
    noise = np.array(jax.random.normal(key, (2, 2, 2, 64), jnp.float32))
    tunet = talt.DispUNet(base=8, num_downs=4)
    tunet.load_state_dict(dispunet_state_dict_from_jax(params))
    with torch.no_grad():
        got = tunet(torch.from_numpy(xs).permute(0, 3, 1, 2),
                    torch.from_numpy(noise).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=2e-5)
    no_noise = np.asarray(apply({"params": params}, xs))
    with torch.no_grad():
        got = tunet(torch.from_numpy(xs).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), no_noise,
                               rtol=1e-5, atol=2e-5)


def test_parity_report_skips_every_family_as_the_jax_cli(tmp_path):
    from sndepth_tpu.cli import parity_report as jreport
    from sndepth_tpu_torch.cli import parity_report
    (tmp_path / "ck").mkdir()
    (tmp_path / "data").mkdir()
    common = ["--checkpoints_dir", str(tmp_path / "ck"), "--data_dir",
              str(tmp_path / "data")]
    jreport.main(common + ["--out_dir", str(tmp_path / "j")])
    got = parity_report.main(common + ["--out_dir", str(tmp_path / "t"),
                                       "--device", "cpu"])
    with open(tmp_path / "j" / "report.json") as f:
        want = json.load(f)
    with open(tmp_path / "t" / "report.json") as f:
        assert json.load(f) == got
    assert got["metrics"] == want["metrics"] == {}
    assert set(got["skipped"]) == set(want["skipped"]) == {
        "kitti_eigen_depth", "nyu_normals", "kitti_motion_miou"}
    for k, v in want["skipped"].items():
        assert [os.path.basename(p) for p in got["skipped"][k]] == [
            os.path.basename(p) for p in v], k
