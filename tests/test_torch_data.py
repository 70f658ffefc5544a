"""The port's own KITTI sequence reader, RAFT3D evaluation loader and
submission codecs against the JAX package's, and the stage-2 training
loop's checkpoints.

The readers get the same files and seeds. The JAX package's reader is held
to its ``cv2`` decoder here (its native codec is switched off for the
comparison), so samples and batches are equal bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import sndepth_tpu.native as jax_native
from sndepth_tpu.data import frame_codecs as jcodecs
from sndepth_tpu.data import kitti_sequence as jreader
from sndepth_tpu.data import raft3d_kitti as jkitti
from sndepth_tpu_torch.core.config import GeoNetConfig
from sndepth_tpu_torch.data import frame_codecs as tcodecs
from sndepth_tpu_torch.data import kitti_sequence as treader
from sndepth_tpu_torch.data import raft3d_kitti as tkitti
from sndepth_tpu_torch.data.synthetic import synthetic_batches
from sndepth_tpu_torch.train import loop


def _write_kitti_tree(root, n=5, frame_w=64, h=40):
    from PIL import Image
    scene = os.path.join(root, "2011_09_26_drive_0001_sync_02")
    os.makedirs(scene, exist_ok=True)
    rng = np.random.RandomState(0)
    lines = []
    for i in range(n):
        img = rng.randint(0, 255, (h, frame_w * 3, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(scene, f"{i:010d}.jpg"))
        with open(os.path.join(scene, f"{i:010d}_cam.txt"), "w") as f:
            f.write("241.67,0.,204.16,0.,246.28,59.0,0.,0.,1.\n")
        lines.append(f"2011_09_26_drive_0001_sync_02 {i:010d}")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return root


def _datasets(root, **kw):
    args = dict(split="train", sequence_length=3, img_width=48, img_height=32,
                frame_width=64, seed=11, **kw)
    return jreader.SequenceDataset(root, **args), treader.SequenceDataset(
        root, **args)


def test_sequence_dataset_matches_the_jax_reader(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    root = _write_kitti_tree(str(tmp_path))
    jds, tds = _datasets(root)
    assert len(tds) == len(jds) == 5
    for i in (0, 3, 3, 4):
        want, got = jds[i], tds[i]
        assert set(got) == set(want) == {"tgt", "src", "intrinsics"}
        assert got["tgt"].shape == (32, 48, 3) and got["tgt"].dtype == np.uint8
        assert got["src"].shape == (32, 48, 6)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_unaugmented_samples_are_area_resized_view_by_view(tmp_path):
    """Without augmentation the 9-channel stack is resized to the working
    size; the result is each view resized on its own, and the intrinsics
    scale with it."""
    import cv2
    root = _write_kitti_tree(str(tmp_path))
    _, tds = _datasets(root, augment=False)
    sample = tds[1]
    views = cv2.cvtColor(cv2.imread(tds.example_names[1] + ".jpg"),
                         cv2.COLOR_BGR2RGB)
    frames = [cv2.resize(np.ascontiguousarray(views[:, 64 * i:64 * (i + 1)]),
                         (48, 32), interpolation=cv2.INTER_AREA)
              for i in range(3)]
    np.testing.assert_array_equal(sample["tgt"], frames[1])
    np.testing.assert_array_equal(sample["src"],
                                  np.concatenate([frames[0], frames[2]], 2))
    np.testing.assert_allclose(sample["intrinsics"][0, 0], 241.67 * 48 / 64)
    np.testing.assert_allclose(sample["intrinsics"][1, 1], 246.28 * 32 / 40)


def test_batch_iterator_matches_the_jax_reader(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    root = _write_kitti_tree(str(tmp_path))
    jds, tds = _datasets(root)
    jb = list(jreader.batch_iterator(jds, 2, shuffle=True, seed=3))
    tb = list(treader.batch_iterator(tds, 2, shuffle=True, seed=3))
    assert len(tb) == len(jb) == 2
    for want, got in zip(jb, tb):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reader_helpers_match_and_reject_bad_widths(tmp_path):
    views = np.arange(4 * 12 * 3, dtype=np.uint8).reshape(4, 12, 3)
    for got, want in zip(treader.split_sequence_image(views, 3, 4),
                         jreader.split_sequence_image(views, 3, 4)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        treader.split_sequence_image(views, 3, 5)
    cam = tmp_path / "c_cam.txt"
    cam.write_text("100.,0.,50.,0.,120.,40.,0.,0.,1.\n")
    np.testing.assert_array_equal(treader.read_intrinsics(str(cam)),
                                  jreader.read_intrinsics(str(cam)))


def test_cli_trains_from_a_data_dir_with_the_ports_reader(tmp_path):
    from sndepth_tpu_torch.cli import train_geonet
    root = _write_kitti_tree(str(tmp_path / "data"), frame_w=416, h=128)
    state, records = train_geonet.main(
        ["--data_dir", root, "--device", "cpu", "--dtype", "float32",
         "--batch_size", "1", "--img_height", "32", "--img_width", "64",
         "--max_steps", "2", "--log_every", "1", "--data_workers", "1",
         "--ckpt_dir", str(tmp_path / "ck"),
         "--graphs_dir", str(tmp_path / "logs")])
    assert state.step == 2 and len(records) == 2
    assert all(np.isfinite(r["loss_total"]) for r in records)


FLOW_CFG = GeoNetConfig(batch_size=1, img_height=32, img_width=64,
                        compute_dtype=torch.float32, train_flow=True)


def _run(cfg, steps, ckpt_dir, resume=False):
    return loop.train_geonet(
        cfg, synthetic_batches(1, 32, 64, seed=cfg.seed), steps, device="cpu",
        ckpt_dir=ckpt_dir, log_every=1, ckpt_every=1, resume=resume)


def test_stage2_loop_checkpoints_and_resumes_the_flow_net(tmp_path):
    ckpt_dir = str(tmp_path / "ck")
    state, records = _run(FLOW_CFG, 2, ckpt_dir)
    assert state.step == 2 and [r["step"] for r in records] == [1, 2]
    for r in records:
        for key in ("loss_total", "loss_full_warp", "loss_full_smooth",
                    "loss_geometric_consistency"):
            assert np.isfinite(r[key]), key
    saved = torch.load(loop.latest_checkpoint(ckpt_dir), weights_only=True)
    assert {"disp_net", "pose_net", "flow_net", "optimizer"} <= set(saved)

    resumed, more = _run(FLOW_CFG, 3, ckpt_dir, resume=True)
    assert resumed.step == 3 and [r["step"] for r in more] == [3]
    again, none = _run(FLOW_CFG, 2, ckpt_dir, resume=True)
    assert again.step == 3 and none == []
    for k, v in again.flow_net.state_dict().items():
        torch.testing.assert_close(v, resumed.flow_net.state_dict()[k],
                                   rtol=0, atol=0)
    n_params = len(again.parameters())
    assert len(again.optimizer.state_dict()["state"]) == n_params


def test_stage2_resume_refuses_a_stage1_checkpoint(tmp_path):
    ckpt_dir = str(tmp_path / "ck")
    stage1 = GeoNetConfig(batch_size=1, img_height=32, img_width=64,
                          compute_dtype=torch.float32)
    _run(stage1, 1, ckpt_dir)
    with pytest.raises(KeyError):
        _run(FLOW_CFG, 2, ckpt_dir, resume=True)


def _write_testing_tree(root, n=3, h=47, w=61):
    from PIL import Image
    seq = os.path.join(root, "testing", "seq")
    calib = os.path.join(root, "testing", "calib_cam_to_cam")
    os.makedirs(seq)
    os.makedirs(calib)
    rng = np.random.RandomState(1)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(seq, f"{i:06d}.png"))
    for i in range(n - 1):                  # the last frame has no file
        with open(os.path.join(calib, f"{i:06d}.txt"), "w") as f:
            f.write("calib_time: 09-Jan-2012 13:57:47\n"
                    f"S_02: 1.392000e+03 5.120000e+02\n"
                    f"K_02: {900.0 + i} 0.0 600.5 0.0 {901.0 + i} 180.25 "
                    "0.0 0.0 1.0\n")
    return root


def test_kitti_eval_dataset_matches_the_jax_loader(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    root = _write_testing_tree(str(tmp_path))
    jds = jkitti.KITTIEvalDataset(root, img_width=48, img_height=32)
    tds = tkitti.KITTIEvalDataset(root, img_width=48, img_height=32)
    assert len(tds) == len(jds) == 3
    for i in range(3):
        want, got = jds[i], tds[i]
        assert set(got) == set(want) == {"tgt", "src", "intrinsics"}
        assert got["tgt"].shape == (32, 48, 3) and got["src"].shape == (
            32, 48, 6)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # Edge-clamped neighbours, and the last calibration for a frame past it.
    np.testing.assert_array_equal(tds[0]["src"][..., :3], tds[0]["tgt"])
    np.testing.assert_array_equal(tds[2]["intrinsics"],
                                  [901.0, 902.0, 600.5, 180.25])
    calib = os.path.join(root, "testing", "calib_cam_to_cam", "000000.txt")
    np.testing.assert_array_equal(tkitti.parse_k02_intrinsics(calib),
                                  jkitti.parse_k02_intrinsics(calib))
    bad = tmp_path / "bad.txt"
    bad.write_text("K_03: 1 0 0 0 1 0 0 0 1\n")
    with pytest.raises(ValueError):
        tkitti.parse_k02_intrinsics(str(bad))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_kitti_codecs_write_the_jax_packages_files(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    rng = np.random.RandomState(2)
    flow = (rng.randn(9, 14, 2) * 30).astype(np.float32)
    valid = (rng.rand(9, 14) > 0.3).astype(np.float32)
    disp = (rng.rand(9, 14) * 100).astype(np.float32)
    for name, v in (("all", None), ("mask", valid)):
        tp, jp = str(tmp_path / f"t_{name}.png"), str(tmp_path / f"j_{name}.png")
        tcodecs.write_flow_kitti(tp, flow, v)
        jcodecs.write_flow_kitti(jp, flow, v)
        assert _bytes(tp) == _bytes(jp)
        got, got_valid = tcodecs.read_flow_kitti(tp)
        want, want_valid = jcodecs.read_flow_kitti(jp)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_valid, want_valid)
        np.testing.assert_array_equal(
            got_valid, np.ones((9, 14)) if v is None else v)
        assert np.abs(got - flow).max() <= 1.0 / 64
    tp, jp = str(tmp_path / "t_disp.png"), str(tmp_path / "j_disp.png")
    tcodecs.write_disp_kitti(tp, disp)
    jcodecs.write_disp_kitti(jp, disp)
    assert _bytes(tp) == _bytes(jp)
    np.testing.assert_array_equal(tcodecs.read_disp_kitti(tp),
                                  jcodecs.read_disp_kitti(jp))
    assert np.abs(tcodecs.read_disp_kitti(tp) - disp).max() <= 1.0 / 256
    with pytest.raises(OSError):
        tcodecs.read_flow_kitti(str(tmp_path / "missing.png"))
    with pytest.raises(OSError):
        tcodecs.read_disp_kitti(str(tmp_path / "missing.png"))


def test_write_prediction_writes_the_jax_packages_artifacts(tmp_path):
    rng = np.random.RandomState(3)
    flow = (rng.randn(8, 12, 2) * 5).astype(np.float32)
    Ts = rng.randn(8, 12, 7).astype(np.float32)
    tau, phi = (rng.randn(8, 12, 3).astype(np.float32) for _ in range(2))
    disp = (rng.rand(8, 12) * 50).astype(np.float32)
    got = tkitti.write_prediction(str(tmp_path / "t"), 7, flow, Ts, tau, phi,
                                  disp1=disp)
    want = jkitti.write_prediction(str(tmp_path / "j"), 7, flow, Ts, tau, phi,
                                   disp1=disp)
    assert set(got) == set(want) == {"flow", "T", "tau", "phi", "disp_0"}
    for key in want:
        assert os.path.relpath(got[key], tmp_path / "t") == os.path.relpath(
            want[key], tmp_path / "j")
        assert _bytes(got[key]) == _bytes(want[key]), key
    assert np.loadtxt(got["T"]).shape == (96, 7)


@pytest.mark.parametrize("hw", [(375, 1242), (128, 416), (13, 21)])
def test_prepare_images_and_depths_pads_to_multiples_of_8(hw):
    h, w = hw
    rng = np.random.RandomState(4)
    im1, im2 = (rng.rand(1, h, w, 3).astype(np.float32) for _ in range(2))
    d1, d2 = (rng.rand(1, h, w).astype(np.float32) for _ in range(2))
    got = tkitti.prepare_images_and_depths(im1, im2, d1, d2, 0.5)
    want = jkitti.prepare_images_and_depths(im1, im2, d1, d2, 0.5)
    for g, w_ in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w_)
    assert got[4] == want[4] == ((-h) % 8, (-w) % 8)
    assert got[0].shape[1] % 8 == 0 and got[2].shape[2] % 8 == 0
    if hw == (375, 1242):
        assert got[0].shape == (1, 376, 1248, 3)


def test_kitti_submission_cli_writes_artifacts_that_read_back(tmp_path):
    """The writer on the CPU at a small size: the artifacts of each frame
    are there, the T dump holds unit quaternions, and the tau / phi dumps
    are its logarithm."""
    from sndepth_tpu_torch.cli import kitti_submission
    from sndepth_tpu_torch.ops import se3
    root = _write_testing_tree(str(tmp_path / "data"), n=3, h=70, w=90)
    out = tmp_path / "out"
    n = kitti_submission.main(
        ["--root", root, "--out_dir", str(out), "--iters", "2",
         "--img_height", "64", "--img_width", "64", "--max_frames", "2",
         "--device", "cpu"])
    assert n == 2
    assert sorted(os.listdir(out / "T")) == ["000000.txt", "000001.txt"]
    assert not os.listdir(out / "disp_0")
    for i in range(2):
        T = torch.from_numpy(np.loadtxt(out / "T" / f"{i:06d}.txt")).float()
        assert T.shape == (64 * 64, 7) and torch.isfinite(T).all()
        assert float((T[:, 3:].norm(dim=-1) - 1).abs().max()) < 1e-5
        logs = np.concatenate([np.loadtxt(out / d / f"{i:06d}.txt")
                               for d in ("tau", "phi")], -1)
        np.testing.assert_allclose(se3.log(T).numpy(), logs, atol=2e-5,
                                   rtol=1e-4)
        flow, valid = tcodecs.read_flow_kitti(
            str(out / "flow" / f"{i:06d}_10.png"))
        assert flow.shape == (64, 64, 2) and (valid == 1).all()
    # An empty tree is not an error.
    assert kitti_submission.main(["--root", str(tmp_path / "none"),
                                  "--device", "cpu"]) == 0


def test_kitti_submission_cli_loads_a_checkpoint(tmp_path):
    from sndepth_tpu_torch.cli import kitti_submission
    from sndepth_tpu_torch.models import raft3d
    model = raft3d.RAFT3D()
    raft3d.init_weights(model, torch.Generator().manual_seed(5))
    sd = {"module." + k: v for k, v in model.state_dict().items()}
    sd["module.cnet.fc.weight"] = torch.zeros(3, 3)   # a reference-only key
    torch.save({"model": sd}, tmp_path / "raft3d.pth")
    fresh = raft3d.RAFT3D()
    kitti_submission.load_raft3d_checkpoint(fresh,
                                            str(tmp_path / "raft3d.pth"))
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, model.state_dict()[k], rtol=0, atol=0)
    del sd["module.fnet.conv1.weight"]
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="fnet.conv1.weight"):
        kitti_submission.load_raft3d_checkpoint(fresh,
                                                str(tmp_path / "short.pth"))
