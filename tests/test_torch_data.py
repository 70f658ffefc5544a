"""The port's own KITTI sequence reader, RAFT3D evaluation loader,
submission codecs, RAFT3D training codecs (.flo, PFM), augmentors and
training readers against the JAX package's, and the stage-2 training loop's
checkpoints.

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
from sndepth_tpu.data import raft3d_augment as jaug
from sndepth_tpu.data import raft3d_datasets as jsets
from sndepth_tpu.data import raft3d_kitti as jkitti
from sndepth_tpu_torch.core.config import GeoNetConfig
from sndepth_tpu_torch.data import frame_codecs as tcodecs
from sndepth_tpu_torch.data import kitti_sequence as treader
from sndepth_tpu_torch.data import raft3d_augment as taug
from sndepth_tpu_torch.data import raft3d_datasets as tsets
from sndepth_tpu_torch.data import raft3d_kitti as tkitti
from sndepth_tpu_torch.data.synthetic import synthetic_batches
from sndepth_tpu_torch.train import loop
from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


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


def test_batch_iterator_parts_make_up_the_global_batches(tmp_path):
    """Two ranks' parts (``part``), each decoded on threads, are the halves
    of the one-thread reader's global batches (the reader the test above
    holds against JAX's), in the same order. Unaugmented: augmentation
    draws in the order of the decodes."""
    root = _write_kitti_tree(str(tmp_path), n=9)
    _, tds = _datasets(root, augment=False)
    want = list(treader.batch_iterator(tds, 4, shuffle=True, seed=5))
    parts = [list(treader.batch_iterator(tds, 4, shuffle=True, seed=5,
                                         part=(2, 2 * r), num_threads=3))
             for r in range(2)]
    assert len(want) == len(parts[0]) == len(parts[1]) == 2
    for w, a, b in zip(want, *parts):
        for k in w:
            np.testing.assert_array_equal(np.concatenate([a[k], b[k]]),
                                          w[k], err_msg=k)


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


# ----------------------------------------------------------------------
# RAFT3D training: codecs, augmentors, readers
# ----------------------------------------------------------------------

def test_flo_and_pfm_readers_read_the_jax_packages_files(tmp_path):
    rng = np.random.RandomState(20)
    flow = rng.randn(7, 9, 2).astype(np.float32)
    jcodecs.write_flo(str(tmp_path / "a.flo"), flow)
    got = tcodecs.read_flo(str(tmp_path / "a.flo"))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, flow)
    np.testing.assert_array_equal(got, jcodecs.read_flo(str(tmp_path / "a.flo")))
    for name, arr, scale in (("gray", rng.rand(6, 8), 1.0),
                             ("color", rng.rand(6, 8, 3), 1.0),
                             ("scaled", rng.rand(5, 4), 2.5)):
        path = str(tmp_path / f"{name}.pfm")
        jcodecs.write_pfm(path, arr.astype(np.float32), scale)
        got, want = tcodecs.read_pfm(path), jcodecs.read_pfm(path)
        assert got.shape == arr.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, arr.astype(np.float32))
    # A big-endian file (positive scale) reads the same values.
    with open(tmp_path / "big.pfm", "wb") as f:
        f.write(b"Pf\n3 2\n1.0\n")
        np.flipud(np.arange(6, dtype=">f4").reshape(2, 3)).tofile(f)
    np.testing.assert_array_equal(tcodecs.read_pfm(str(tmp_path / "big.pfm")),
                                  np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_array_equal(tcodecs.read_pfm(str(tmp_path / "big.pfm")),
                                  jcodecs.read_pfm(str(tmp_path / "big.pfm")))
    (tmp_path / "bad.flo").write_bytes(b"XXXX" + bytes(16))
    with pytest.raises(ValueError, match="magic"):
        tcodecs.read_flo(str(tmp_path / "bad.flo"))
    (tmp_path / "bad.pfm").write_bytes(b"P6\n3 2\n1.0\n")
    with pytest.raises(ValueError, match="PFM"):
        tcodecs.read_pfm(str(tmp_path / "bad.pfm"))
    (tmp_path / "bad2.pfm").write_bytes(b"Pf\nthree two\n1.0\n")
    with pytest.raises(ValueError, match="header"):
        tcodecs.read_pfm(str(tmp_path / "bad2.pfm"))


def test_flo_and_pfm_writers_write_the_jax_packages_bytes(tmp_path):
    """The port's ``write_flo`` and ``write_pfm`` write the bytes the JAX
    writers write, and each package reads the other's file back exactly."""
    rng = np.random.RandomState(21)
    flow = rng.randn(5, 7, 2)
    cases = [("flo", flow, tcodecs.write_flo, jcodecs.write_flo, ())]
    for name, arr, scale in (("gray", rng.rand(6, 8), 1.0),
                             ("color", rng.rand(6, 8, 3), 1.0),
                             ("scaled", rng.rand(5, 4), 2.5)):
        cases.append((name + ".pfm", arr, tcodecs.write_pfm,
                      jcodecs.write_pfm, (scale,)))
    for name, arr, twrite, jwrite, extra in cases:
        ext = ".flo" if name == "flo" else ""
        tpath, jpath = (str(tmp_path / f"{side}_{name}{ext}")
                        for side in ("t", "j"))
        twrite(tpath, arr, *extra)
        jwrite(jpath, arr, *extra)
        assert open(tpath, "rb").read() == open(jpath, "rb").read(), name
        np.testing.assert_array_equal(tcodecs.read_gen(jpath),
                                      jcodecs.read_gen(tpath))
        np.testing.assert_array_equal(tcodecs.read_gen(tpath),
                                      arr.astype(np.float32))


def test_dpt_cam_and_read_gen_match_the_jax_package(tmp_path):
    """Sintel ``.dpt`` and ``.cam`` files and every extension of
    ``read_gen``: the same bytes written, the same values read, bit for
    bit, and the same refusals."""
    from PIL import Image
    rng = np.random.RandomState(22)
    depth = (1 + 10 * rng.rand(9, 11)).astype(np.float32)
    tcodecs.write_dpt(str(tmp_path / "t.dpt"), depth)
    jcodecs.write_dpt(str(tmp_path / "j.dpt"), depth)
    assert (tmp_path / "t.dpt").read_bytes() == (tmp_path / "j.dpt").read_bytes()
    got = tcodecs.read_dpt(str(tmp_path / "j.dpt"))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, depth)
    np.testing.assert_array_equal(got, jcodecs.read_dpt(str(tmp_path / "t.dpt")))

    from scipy.spatial.transform import Rotation
    M = np.array([[700.0, 0, 320.5], [0, 710.0, 240.25], [0, 0, 1]])
    rot = Rotation.from_rotvec([0.1, -0.2, 0.3]).as_matrix()
    N = np.concatenate([rot, [[1.5], [-2.0], [0.25]]], 1)
    tcodecs.write_cam(str(tmp_path / "t.cam"), M, N)
    jcodecs.write_cam(str(tmp_path / "j.cam"), M, N)
    assert (tmp_path / "t.cam").read_bytes() == (tmp_path / "j.cam").read_bytes()
    (tp, tk), (jp, jk) = (tcodecs.read_cam(str(tmp_path / "t.cam")),
                          jcodecs.read_cam(str(tmp_path / "t.cam")))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tk, [700.0, 710.0, 320.5, 240.25])
    np.testing.assert_array_equal(tp[:3], [1.5, -2.0, 0.25])

    img = rng.randint(0, 256, (6, 10, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    np.save(tmp_path / "a.bin", depth)
    os.replace(tmp_path / "a.bin.npy", tmp_path / "a.bin")
    for name in ("a.png", "a.bin", "t.dpt"):
        got = tcodecs.read_gen(str(tmp_path / name))
        want = jcodecs.read_gen(str(tmp_path / name))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcodecs.read_gen(str(tmp_path / "a.png")),
                                  img)
    tp2, tk2 = tcodecs.read_gen(str(tmp_path / "j.cam"))
    np.testing.assert_array_equal(tp2, jp)
    np.testing.assert_array_equal(tk2, jk)

    (tmp_path / "bad.dpt").write_bytes(np.float32(1.0).tobytes() + bytes(8))
    for codecs in (tcodecs, jcodecs):
        with pytest.raises(ValueError, match="tag"):
            codecs.read_dpt(str(tmp_path / "bad.dpt"))
        with pytest.raises(ValueError, match="extension"):
            codecs.read_gen(str(tmp_path / "a.xyz"))


def _rgbd_inputs(seed, h=60, w=90):
    rng = np.random.RandomState(seed)
    im1, im2 = (rng.randint(0, 255, (h, w, 3)).astype(np.float32)
                for _ in range(2))
    d1, d2 = ((1 + rng.rand(h, w)).astype(np.float32) for _ in range(2))
    flow = rng.randn(h, w, 3).astype(np.float32)
    valid = (rng.rand(h, w) > 0.5).astype(np.float32)
    k = np.array([100.0, 101.0, w / 2, h / 2], np.float32)
    return im1, im2, d1, d2, flow, valid, k


def test_color_jitter_matches_the_jax_package():
    img = np.random.RandomState(21).rand(12, 16, 3).astype(np.float32)
    for seed in range(4):
        got = taug.color_jitter(np.random.RandomState(seed), img)
        want = jaug.color_jitter(np.random.RandomState(seed), img)
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("sparse", [False, True], ids=["rgbd", "sparse"])
def test_augmentors_match_the_jax_package_call_for_call(sparse):
    """The same seed gives the same draws: six calls in a row, so that both
    the resized and the unresized branch (1 call in 5) are met."""
    cls = "SparseAugmentor" if sparse else "RGBDAugmentor"
    ours, theirs = (getattr(m, cls)((32, 48), seed=3) for m in (taug, jaug))
    resized = set()
    for call in range(6):
        im1, im2, d1, d2, flow, valid, k = _rgbd_inputs(30 + call)
        args = ((im1, im2, d1, d2, flow, valid, k) if sparse
                else (im1, im2, d1, d2, flow, k))
        got, want = ours(*args), theirs(*args)
        assert len(got) == len(want) == (7 if sparse else 6)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[0].shape == (32, 48, 3) and got[2].shape == (32, 48)
        resized.add(bool(got[-1][0] != k[0]))
    assert resized == {False, True}
    scattered, scattered_valid = taug.resize_sparse_image(flow, valid, 45, 70)
    want, want_valid = jaug.resize_sparse_image(flow, valid, 45, 70)
    np.testing.assert_array_equal(scattered, want)
    np.testing.assert_array_equal(scattered_valid, want_valid)


def _write_kitti_training_tree(root, n=3, h=120, w=140):
    """A ``training`` tree of a KITTI scene-flow root: image pairs, sparse
    and dense disparities, occluded flow and calibration, made from a
    seed."""
    import cv2
    rng = np.random.RandomState(22)
    base = os.path.join(root, "training")
    dirs = ("image_2", "disp_occ_0", "disp_occ_1", "disp_ganet_training",
            "flow_occ", "calib_cam_to_cam")
    for d in dirs:
        os.makedirs(os.path.join(base, d), exist_ok=True)
    for i in range(n):
        for t in (10, 11):
            img = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
            cv2.imwrite(os.path.join(base, "image_2", f"{i:06d}_{t}.png"), img)
            jcodecs.write_disp_kitti(
                os.path.join(base, "disp_ganet_training", f"{i:06d}_{t}.png"),
                (5 + 60 * rng.rand(h, w)).astype(np.float32))
        for d in ("disp_occ_0", "disp_occ_1"):
            sparse = (60 * rng.rand(h, w) * (rng.rand(h, w) > 0.4))
            jcodecs.write_disp_kitti(
                os.path.join(base, d, f"{i:06d}_10.png"),
                sparse.astype(np.float32))
        jcodecs.write_flow_kitti(
            os.path.join(base, "flow_occ", f"{i:06d}_10.png"),
            (rng.randn(h, w, 2) * 8).astype(np.float32),
            (rng.rand(h, w) > 0.3).astype(np.float32))
        with open(os.path.join(base, "calib_cam_to_cam", f"{i:06d}.txt"),
                  "w") as f:
            f.write(f"K_02: {700.0 + i} 0.0 70.0 0.0 {705.0 + i} 60.0 "
                    "0.0 0.0 1.0\n")
    return root


@pytest.mark.parametrize("augment", [True, False], ids=["augmented", "raw"])
def test_kitti_scene_flow_dataset_matches_the_jax_reader(tmp_path, monkeypatch,
                                                         augment):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    root = _write_kitti_training_tree(str(tmp_path))
    kw = dict(do_augment=augment, image_size=(24, 64), seed=4)
    jds = jsets.KITTISceneFlowDataset(root, **kw)
    tds = tsets.KITTISceneFlowDataset(root, **kw)
    assert len(tds) == len(jds) == 3
    keys = {"image1", "image2", "depth1", "depth2", "flow", "valid",
            "intrinsics"}
    for i in (0, 2, 1, 0):
        want, got = jds[i], tds[i]
        assert set(got) == set(want) == keys
        for k in keys:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if augment:
            assert got["image1"].shape == (24, 64, 3)
            assert got["flow"].shape == (24, 64, 3)
        else:
            assert got["image1"].shape == (40, 140, 3)    # 80 sky rows cut
            assert got["intrinsics"][3] == 60.0 - 80
        assert set(np.unique(got["valid"])) <= {0.0, 1.0}
    assert len(tsets.KITTISceneFlowDataset(str(tmp_path / "none"))) == 0
    # The reader's items collate into the batches the train step takes.
    batch = next(treader.batch_iterator(tds, 2, shuffle=False))
    assert batch["image1"].shape[0] == 2 and batch["intrinsics"].shape == (2, 4)


def _write_things_tree(root, frames=3, h=40, w=56):
    """A FlyingThings3D-style tree: clean-pass frames, PFM disparities and
    .flo flows into the future of one scene, left camera."""
    import cv2
    rng = np.random.RandomState(23)
    rel = os.path.join("TRAIN", "A", "0000")
    idir = os.path.join(root, "frames_cleanpass", rel, "left")
    ddir = os.path.join(root, "disparity", rel, "left")
    fdir = os.path.join(root, "optical_flow", rel, "into_future", "left")
    for d in (idir, ddir, fdir):
        os.makedirs(d, exist_ok=True)
    for i in range(frames):
        name = f"{i + 6:04d}"
        cv2.imwrite(os.path.join(idir, name + ".png"),
                    rng.randint(0, 255, (h, w, 3), dtype=np.uint8))
        # Disparities are stored negated in places: the reader takes |d|.
        jcodecs.write_pfm(os.path.join(ddir, name + ".pfm"),
                          -(5 + 30 * rng.rand(h, w)).astype(np.float32))
        jcodecs.write_flo(
            os.path.join(fdir, f"OpticalFlowIntoFuture_{name}_L.flo"),
            (rng.randn(h, w, 2) * 4).astype(np.float32))
    return root


@pytest.mark.parametrize("augment", [True, False], ids=["augmented", "raw"])
def test_scene_flow_dataset_matches_the_jax_reader(tmp_path, augment):
    root = _write_things_tree(str(tmp_path))
    kw = dict(do_augment=augment, image_size=(24, 32), seed=6)
    jds = jsets.SceneFlowDataset(root, **kw)
    tds = tsets.SceneFlowDataset(root, **kw)
    assert len(tds) == len(jds) == 2              # pairs of 3 frames
    for i in (0, 1, 0):
        want, got = jds[i], tds[i]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert (got["depth1"] > 0).all() and (got["valid"] == 1).all()
        assert got["image1"].shape == ((24, 32, 3) if augment
                                       else (40, 56, 3))


def test_flyingthings_test_split_matches_the_jax_reader(tmp_path):
    """The 3-D flow is back-projected by the port's own
    ``ops/projective.backproject_flow3d`` on CPU tensors: float32 products
    in another association than XLA's, held to rtol 1e-5 + atol 1e-5."""
    import pickle

    import cv2
    root = str(tmp_path / "FlyingThings3D")
    rng = np.random.RandomState(24)
    h, w = 16, 20
    rel = os.path.join("TEST", "A", "0000")

    def put(kind, sub, name, arr):
        d = os.path.join(root, kind, rel, sub)
        os.makedirs(d, exist_ok=True)
        if name.endswith(".png"):
            cv2.imwrite(os.path.join(d, name), arr)
        else:
            jcodecs.write_pfm(os.path.join(d, name), arr)

    for frame in ("0006", "0007"):
        put("frames_cleanpass", "left", frame + ".png",
            rng.randint(0, 255, (h, w, 3), dtype=np.uint8))
        put("disparity", "left", frame + ".pfm",
            (5 + 30 * rng.rand(h, w)).astype(np.float32))
    put("optical_flow", os.path.join("into_future", "left"),
        "OpticalFlowIntoFuture_0006_L.pfm",
        rng.randn(h, w, 3).astype(np.float32))
    put("disparity_change", os.path.join("into_future", "left"), "0006.pfm",
        rng.rand(h, w).astype(np.float32))
    pkl = str(tmp_path / "things_test_data.pickle")
    with open(pkl, "wb") as f:
        pickle.dump([("TEST_A_0000_left_0006", np.array([3, 5, 7]),
                      np.array([530, 531, 532]),
                      np.array([True, True, False]))], f)
    jds = jsets.FlyingThingsTest(root, pickle_path=pkl)
    tds = tsets.FlyingThingsTest(root)            # the pickle beside the root
    assert len(tds) == len(jds) == 1
    want, got = jds[0], tds[0]
    assert set(got) == set(want)
    for k in want:
        if k == "flow3d":
            assert got[k].dtype == np.float32 and np.isfinite(got[k]).all()
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["sampled_index"], [[9, 8], [3, 5]])


def test_train_raft3d_cli_trains_from_a_kitti_root(tmp_path):
    """The train CLI on the CPU over the port's reader on a generated
    KITTI tree: two steps at 64x64, finite metrics, and the two files of the
    checkpoint (their round trip is in ``test_torch_raft3d_train.py``)."""
    from sndepth_tpu_torch.cli import train_raft3d
    root = _write_kitti_training_tree(str(tmp_path / "data"), n=2, h=160,
                                      w=200)
    ckpt = str(tmp_path / "ckpt")
    state, records = train_raft3d.main(
        ["--root", root, "--ckpt_dir", ckpt, "--batch_size", "1",
         "--img_height", "64", "--img_width", "64", "--iters", "1",
         "--max_steps", "2", "--log_every", "1", "--device", "cpu"])
    assert state.step == 2 and [r["step"] for r in records] == [1, 2]
    for r in records:
        assert all(np.isfinite(r[k]) for k in ("loss", "epe2d", "grad_norm"))
    assert state.model.dtype == torch.bfloat16
    assert sorted(os.listdir(ckpt)) == ["raft3d.pth", "raft3d_train_state.pt"]


# --- the image-folder dataset, image_split and convert_weights -------------

def _write_folder(root, n=3, h=30, w=50):
    from PIL import Image
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(4)
    for i, ext in zip(range(n), (".png", ".jpg", ".bmp")):
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(
            os.path.join(root, f"f{i}{ext}"))
    return root


def test_custom_folder_dataset_matches_the_jax_loader(tmp_path,
                                                      monkeypatch):
    from sndepth_tpu.data.custom import CustomFolderDataset as JaxFolder
    from sndepth_tpu_torch.data.custom import CustomFolderDataset
    monkeypatch.setattr(jax_native, "available", lambda: False)
    root = _write_folder(str(tmp_path / "imgs"))
    jds, tds = JaxFolder(root, 48, 32), CustomFolderDataset(root, 48, 32)
    assert len(tds) == len(jds) == 3 and tds.paths == jds.paths
    for i in range(3):
        got, want = tds[i], jds[i]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(FileNotFoundError):
        CustomFolderDataset(str(tmp_path / "empty"))


def test_image_split_writes_the_jax_cli_crops(tmp_path):
    from PIL import Image

    from sndepth_tpu.cli import image_split as jsplit
    from sndepth_tpu_torch.cli import image_split
    src = tmp_path / "frames"
    src.mkdir()
    rng = np.random.RandomState(5)
    for i, w in enumerate((1280, 700)):
        Image.fromarray(rng.randint(0, 255, (20, w, 3), np.uint8)).save(
            src / f"{i:06d}.png")
    jsplit.main(["--in_dir", str(src), "--out_dir", str(tmp_path / "j")])
    assert image_split.main(["--in_dir", str(src), "--out_dir",
                             str(tmp_path / "t")]) == 6
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    for name in names:
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "t" / name)),
            np.asarray(Image.open(tmp_path / "j" / name)), err_msg=name)
    img = rng.randint(0, 255, (4, 1280, 3), np.uint8)
    for a, b in zip(image_split.split_image(img), jsplit.split_image(img)):
        np.testing.assert_array_equal(a, b)


def _prefixed(sd: dict, prefix: str) -> dict:
    return {prefix + k: v for k, v in sd.items()}


@pytest.fixture
def big_tmp(tmp_path):
    """``tmp_path``, emptied when the test ends: these tests write
    checkpoints of full-width nets (0.1-0.4 GB each)."""
    yield tmp_path
    import shutil
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_convert_weights_geonet_writes_a_params_only_step_file(big_tmp):
    """The reference's pair (DataParallel prefixes, under
    ``*_net_state_dict``) becomes a step file that loads strictly and that
    ``restore_params_or_state`` grafts onto a train state."""
    from sndepth_tpu_torch.cli import convert_weights
    from sndepth_tpu_torch.train import checkpoint as ckpt_lib
    from sndepth_tpu_torch.train import geonet as tgeo
    cfg = GeoNetConfig(batch_size=1, img_height=32, img_width=64,
                       compute_dtype=torch.float32)
    src = tgeo.create_train_state(GeoNetConfig(seed=3), "cpu")
    torch.save({"disp_net_state_dict": _prefixed(
        src.disp_net.state_dict(), "module.")}, big_tmp / "depth.pth")
    torch.save(src.pose_net.state_dict(), big_tmp / "pose.pth")
    path = convert_weights.main([
        "geonet", "--depth", str(big_tmp / "depth.pth"), "--pose",
        str(big_tmp / "pose.pth"), "--out", str(big_tmp / "out")])
    assert path.endswith("step_00000000.pt")
    state = tgeo.create_train_state(cfg, "cpu")
    ckpt_lib.restore_params_or_state(str(big_tmp / "out"), state)
    for name in ("disp_net", "pose_net"):
        want = getattr(src, name).state_dict()
        got = getattr(state, name).state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_convert_weights_each_family_loads_strictly(big_tmp):
    """Each family's reference layout, generated from a port model (small
    where the family has a small form), converts to a state dict that
    loads with ``strict=True``; a checkpoint missing a key is refused."""
    from sndepth_tpu_torch.cli import convert_weights as cw
    from sndepth_tpu_torch.cli.train_uniad import small_model
    from sndepth_tpu_torch.models.motionseg import MotionFusionNet
    from sndepth_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from sndepth_tpu_torch.models.vit import ViT

    def vae():
        return AutoencoderKL(VAEConfig(base_ch=32, ch_mult=(1, 2),
                                       num_res_blocks=1))
    cases = {
        "raft3d": (lambda: cw.default_model("raft3d"),
                   lambda sd: {"model": _prefixed(sd, "module.")}),
        "vae": (vae, lambda sd: {"state_dict": _prefixed(
            sd, "first_stage_model.")}),
        "motion": (MotionFusionNet, lambda sd: _prefixed(sd, "module.")),
        "dino": (lambda: ViT(depth=2), lambda sd: {"teacher": _prefixed(
            sd, "backbone.")}),
        "uniad": (small_model, lambda sd: {"state_dict": {
            **sd, "motion_head.w": torch.zeros(1)}}),
    }
    for kind, (make, wrap) in cases.items():
        torch.manual_seed(0)
        src = make()
        want = src.state_dict()
        path = str(big_tmp / f"{kind}.pth")
        torch.save(wrap(want), path)
        fresh = make()
        got = cw.convert_checkpoint(kind, path, model=fresh)
        fresh.load_state_dict(got, strict=True)
        for k, v in want.items():
            assert torch.equal(fresh.state_dict()[k], v), (kind, k)
    torch.save({"state_dict": {}}, big_tmp / "empty.pth")
    with pytest.raises(KeyError):
        cw.convert_checkpoint("uniad", str(big_tmp / "empty.pth"),
                              model=small_model())


def test_convert_weights_nnet_matches_the_jax_converter(big_tmp):
    """``nyu.pt`` (``encoder.original_model.*`` and ``decoder.*`` under
    ``"model"``, DataParallel prefixes) -> ``nnet.pth`` equals the JAX
    ``convert_nnet_checkpoint`` carried back by the port's
    ``utils.weights``, and loads strictly into the encoder and decoder."""
    from sndepth_tpu.utils.convert_weights import convert_nnet_checkpoint
    from sndepth_tpu_torch.cli import convert_weights
    from sndepth_tpu_torch.models import nnet as nnet_lib
    from sndepth_tpu_torch.train.nnet import NormalNet
    from sndepth_tpu_torch.utils import weights as tw
    net = NormalNet()
    nnet_lib.init_weights(net, torch.Generator().manual_seed(1))
    ref = {("module.encoder.original_model." + k[len("encoder."):]
            if k.startswith("encoder.") else "module." + k): v
           for k, v in net.state_dict().items()}
    torch.save({"model": ref}, big_tmp / "nyu.pt")
    path = convert_weights.main(["nnet", "--ckpt", str(big_tmp / "nyu.pt"),
                                 "--out", str(big_tmp / "out")])
    assert path.endswith("nnet.pth")
    got = torch.load(path, weights_only=True)
    jv = convert_nnet_checkpoint(str(big_tmp / "nyu.pt"))
    want: dict = {}
    tw._efficientnet(want, "encoder.", jv["encoder"]["params"],
                     jv["encoder"]["batch_stats"])
    tw._normal_decoder(want, "decoder.", jv["decoder"]["params"],
                       jv["decoder"].get("batch_stats"))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k].to(got[k].dtype), rtol=0,
                                   atol=0, msg=k)
    fresh = NormalNet()
    fresh.load_state_dict(got, strict=True)
