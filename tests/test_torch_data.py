"""The port's own KITTI sequence reader against the JAX package's, and the
stage-2 training loop's checkpoints.

The readers get the same files and seeds. The JAX package's reader is held
to its ``cv2`` decoder here (its native codec is switched off for the
comparison), so samples and batches are equal bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import sndepth_tpu.native as jax_native
from sndepth_tpu.data import kitti_sequence as jreader
from sndepth_tpu_torch.core.config import GeoNetConfig
from sndepth_tpu_torch.data import kitti_sequence as treader
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
