"""The port imports without JAX and without the JAX package, and a kernel
request that cannot run on the card raises instead of falling back to the
plain version."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import sndepth_tpu_torch
from sndepth_tpu_torch.kernels import dssim as K7
from sndepth_tpu_torch.kernels import gn_build as K8
from sndepth_tpu_torch.kernels import photo_loss as K1
from sndepth_tpu_torch.kernels import smooth_loss as K2
from sndepth_tpu_torch.kernels import warp as K5
from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield

BLOCKED = ("jax", "jaxlib", "flax", "optax", "sndepth_tpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        sndepth_tpu_torch.__path__, "sndepth_tpu_torch."))


def test_every_module_imports_with_jax_unavailable():
    """Every module imports, and a stage-2 step, a RAFT3D frame, a RAFT3D
    train step, the GeoNet -> NNET -> RAFT3D prediction and the CLIs run
    (so the imports inside functions run too), with JAX and the JAX package
    blocked."""
    names = _modules()
    for name in ("cli.train_geonet", "cli.benchmark", "cli.kitti_submission",
                 "cli.profile_step", "data.kitti_sequence",
                 "data.raft3d_kitti", "data.frame_codecs", "kernels.gn_build",
                 "models.raft3d", "models.grid_smoother", "ops.se3",
                 "ops.projective", "ops.resize", "ops.patches", "pipelines",
                 "cli.train_raft3d", "train.raft3d", "data.raft3d_augment",
                 "data.raft3d_datasets", "utils.metrics", "ops.norm",
                 "ops.edges", "models.efficientnet", "models.normal_decoder",
                 "models.nnet", "data.nyu", "utils.visualize",
                 "cli.evaluate_depth", "cli.evaluate_normals",
                 "cli.predict_raft3d", "utils.profiling"):
        assert f"sndepth_tpu_torch.{name}" in names, name
    code = ("import sys, tempfile\n"
            "import torch\n"
            "torch.set_num_threads(2)\n"
            f"for m in {BLOCKED!r}:\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "from sndepth_tpu_torch.cli import benchmark, train_geonet\n"
            "from sndepth_tpu_torch.cli import kitti_submission\n"
            "small = ['--img_height', '16', '--img_width', '32',\n"
            "         '--device', 'cpu']\n"
            "benchmark.main(['--family', 'flow', '--batch', '1',\n"
            "                '--iters', '1'] + small)\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    train_geonet.main(['--max_steps', '1', '--batch_size', '1',\n"
            "                       '--ckpt_dir', d + '/c',\n"
            "                       '--graphs_dir', d + '/l'] + small)\n"
            "benchmark.main(['--family', 'raft3d', '--iters', '1',\n"
            "                '--img_height', '64', '--img_width', '64',\n"
            "                '--device', 'cpu'])\n"
            "import os, numpy as np\n"
            "from PIL import Image\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    os.makedirs(d + '/testing/seq')\n"
            "    os.makedirs(d + '/testing/calib_cam_to_cam')\n"
            "    for i in range(2):\n"
            "        Image.fromarray(np.full((70, 90, 3), 40 * i, np.uint8)\n"
            "                        ).save(d + f'/testing/seq/{i:06d}.png')\n"
            "        open(d + f'/testing/calib_cam_to_cam/{i:06d}.txt', 'w'\n"
            "             ).write('K_02: 50 0 32 0 50 32 0 0 1\\n')\n"
            "    n = kitti_submission.main(\n"
            "        ['--root', d, '--out_dir', d + '/out', '--iters', '1',\n"
            "         '--img_height', '64', '--img_width', '64',\n"
            "         '--max_frames', '1', '--device', 'cpu'])\n"
            "    assert n == 1 and os.path.exists(d + '/out/T/000000.txt')\n"
            "from sndepth_tpu_torch.cli import train_raft3d\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    state, records = train_raft3d.main(\n"
            "        ['--max_steps', '1', '--batch_size', '1', '--iters', '1',\n"
            "         '--img_height', '64', '--img_width', '64',\n"
            "         '--log_every', '1', '--root', d + '/none',\n"
            "         '--ckpt_dir', d + '/ckpt', '--device', 'cpu'])\n"
            "    assert state.step == 1 and len(records) == 1\n"
            "    assert records[0]['loss'] == records[0]['loss']\n"
            "    assert os.path.exists(d + '/ckpt/raft3d.pth')\n"
            "from sndepth_tpu_torch.cli import predict_raft3d\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    out = predict_raft3d.main(\n"
            "        ['--synthetic', '--iters', '1', '--img_height', '64',\n"
            "         '--img_width', '64', '--out_dir', d, '--device', 'cpu'])\n"
            "    assert all(os.path.exists(p) for p in out[0]['paths'].values())\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            f"       {BLOCKED!r}\n"
            "       and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    # Two threads, as the test processes beside it have.
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("ok")


def test_no_source_line_imports_jax_or_the_jax_package():
    """A scan of the port's sources and of chip_smoke.py: it also sees an
    import inside a function that no test happens to run."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|sndepth_tpu)(\.|\s|$)")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "sndepth_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 20
    bad = []
    for path in paths:
        with open(path) as f:
            bad += [(path, n, line) for n, line in enumerate(f, 1)
                    if pattern.match(line)]
    assert not bad, bad
    assert pattern.match("    from sndepth_tpu.data import x")
    assert not pattern.match("from sndepth_tpu_torch.ops import warp")


def _photo_inputs(device="cpu"):
    b, ns, h, w = 1, 2, 8, 12
    return (torch.zeros(b, 3, h, w, device=device),
            torch.zeros(b, ns, 3, h, w, device=device),
            torch.zeros(b, ns, 2, h, w, device=device),
            torch.zeros(b, ns, 2, h, w, device=device))


def _smooth_inputs(device="cpu"):
    return (torch.ones(2, 1, 8, 12, device=device),
            torch.zeros(2, 3, 8, 12, device=device))


def _gn_inputs(device="cpu"):
    b, n = 1, 6
    z = lambda *shape: torch.zeros(*shape, device=device)
    rot = torch.eye(3, device=device).expand(b, n, 3, 3).contiguous()
    grid = torch.arange(n, device=device)
    return (rot, z(b, n, 3) + 2.0, z(b, n, 32), z(b, n), grid // 3, grid % 3,
            z(b, n, 3) + 1.0, z(b, n, 3), z(b, n, 3) + 1.0, z(b, 4) + 10.0)


def _counts():
    return [f.launches for f in (
        K1.photo_pair_sums, K1.photo_sums, K1.photo_pair_weighted_sums,
        K2.smooth_sums, K5.warp_gather, K5.warp_coord_grad, K5.warp_splat,
        K7.dssim_forward,
        K7.dssim_backward, K8.gn_build_hg, K8.gn_build_bwd)]


def test_kernel_launch_without_a_card_raises():
    """The launch path (what a CUDA tensor takes) needs nvcc and the card;
    without them it raises rather than computing anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    before = _counts()
    tgt, srcs, cf, cb = _photo_inputs()
    w = torch.ones(1, 2, 8, 12)
    x = torch.zeros(2, 3, 8, 12)
    coords = torch.zeros(2, 2, 8, 12)
    for launch in (lambda: K1._launch(tgt, srcs, cf, cb, 0.85),
                   lambda: K1._launch(tgt, srcs, cf, None, 0.85),
                   lambda: K1._launch(tgt, srcs, cf, cb, 0.85, w, w),
                   lambda: K2._launch(*_smooth_inputs()),
                   lambda: K5._launch_gather(x, coords, "edge_zero"),
                   lambda: K5._launch_gather(x, coords, "zero_pad"),
                   lambda: K5._launch_coord_grad(x, coords, x, "edge_zero"),
                   lambda: K5._launch_splat(coords, x, 8, 12, "edge_zero"),
                   lambda: K7._launch_forward(x, x),
                   lambda: K7._launch_backward(x, x, x, True, True),
                   lambda: K8._launch(*_gn_inputs(), 1),
                   lambda: K8.gn_build_bwd(
                       K8._kernel_inputs(*_gn_inputs()),
                       torch.zeros(1, 6, 6, 6), torch.zeros(1, 6, 6), 1)):
        with pytest.raises((RuntimeError, OSError)):
            launch()
    assert _counts() == before


def test_other_devices_raise_rather_than_fall_back():
    with pytest.raises(ValueError):
        K1.photo_pair_sums(*_photo_inputs("meta"), 0.85)
    with pytest.raises(ValueError):
        K2.smooth_sums(*_smooth_inputs("meta"))
    x = torch.zeros(2, 3, 8, 12, device="meta")
    coords = torch.zeros(2, 2, 8, 12, device="meta")
    with pytest.raises(ValueError):
        K5.warp_gather(x, coords, "edge_zero")
    with pytest.raises(ValueError):
        K5.warp_coord_grad(x, coords, x, "edge_zero")
    with pytest.raises(ValueError):
        K5.warp_splat(coords, x, 8, 12, "edge_zero")
    with pytest.raises(ValueError):
        K7.dssim_forward(x, x)
    with pytest.raises(ValueError):
        K7.dssim_backward(x, x, x)
    with pytest.raises(ValueError):
        K8.gn_build_hg(*_gn_inputs("meta"), 1)
    with pytest.raises(ValueError):
        K8.gn_build_hg_bwd(*_gn_inputs("meta"), 1,
                           torch.zeros(1, 6, 6, 6, device="meta"),
                           torch.zeros(1, 6, 6, device="meta"))


def test_cpu_tensors_take_the_plain_versions_without_counting():
    before = _counts()
    loss, d_cf, d_cb = K1.photo_pair_sums(*_photo_inputs(), 0.85)
    sx, sy, ddx, ddy = K2.smooth_sums(*_smooth_inputs())
    assert d_cf.shape == (1, 2, 2, 8, 12) and ddx.shape == (2, 1, 8, 12)
    assert float(sx) == 0.0 and float(sy) == 0.0
    x = torch.zeros(2, 3, 8, 12)
    coords = torch.zeros(2, 2, 8, 12)
    assert K5.warp_gather(x, coords, "zero_pad").shape == (2, 3, 8, 12)
    assert K5.warp_coord_grad(x, coords, x, "zero_pad").shape == (2, 2, 8, 12)
    assert K5.warp_splat(coords, x, 5, 7, "edge_zero").shape == (2, 3, 5, 7)
    assert K7.dssim_forward(x, x).shape == (2, 3, 8, 12)
    assert K7.dssim_backward(x, x, x)[1].shape == (2, 3, 8, 12)
    H, g = K8.gn_build_hg(*_gn_inputs(), 1)
    assert H.shape == (1, 6, 6, 6) and g.shape == (1, 6, 6)
    assert torch.isfinite(H).all() and torch.equal(H, H.transpose(-1, -2))
    grads = K8.gn_build_hg_bwd(*_gn_inputs(), 1, torch.ones(1, 6, 6, 6),
                               torch.ones(1, 6, 6))
    assert len(grads) == 8 and grads[2].shape == (1, 6, 32)
    assert all(torch.isfinite(g).all() for g in grads)
    assert _counts() == before


def test_cli_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from sndepth_tpu_torch.cli import train_geonet
    with pytest.raises((AssertionError, RuntimeError)):
        train_geonet.main(["--max_steps", "1", "--batch_size", "1",
                           "--img_height", "32", "--img_width", "64",
                           "--ckpt_dir", str(tmp_path / "ckpt"),
                           "--graphs_dir", str(tmp_path / "logs")])


def test_benchmark_cli_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from sndepth_tpu_torch.cli import benchmark
    with pytest.raises((AssertionError, RuntimeError)):
        benchmark.main(["--family", "flow", "--batch", "1", "--iters", "1",
                        "--img_height", "16", "--img_width", "32"])


def test_kitti_submission_cli_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import numpy as np
    from PIL import Image
    from sndepth_tpu_torch.cli import kitti_submission
    (tmp_path / "testing" / "seq").mkdir(parents=True)
    (tmp_path / "testing" / "calib_cam_to_cam").mkdir()
    Image.fromarray(np.zeros((70, 90, 3), np.uint8)).save(
        tmp_path / "testing" / "seq" / "000000.png")
    (tmp_path / "testing" / "calib_cam_to_cam" / "000000.txt").write_text(
        "K_02: 50 0 32 0 50 32 0 0 1\n")
    with pytest.raises((AssertionError, RuntimeError)):
        kitti_submission.main(["--root", str(tmp_path), "--out_dir",
                               str(tmp_path / "out"), "--img_height", "64",
                               "--img_width", "64"])
    assert not (tmp_path / "out").exists()


def test_train_raft3d_cli_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from sndepth_tpu_torch.cli import train_raft3d
    with pytest.raises((AssertionError, RuntimeError)):
        train_raft3d.main(["--max_steps", "1", "--batch_size", "1",
                           "--img_height", "64", "--img_width", "64",
                           "--iters", "1", "--root", str(tmp_path / "none"),
                           "--ckpt_dir", str(tmp_path / "ckpt")])
    assert not (tmp_path / "ckpt").exists()


def test_profile_step_cli_needs_a_card_and_knows_the_train_family(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from sndepth_tpu_torch.cli import profile_step
    with pytest.raises(SystemExit) as exc:
        profile_step.main(["--family", "raft3d_train"])
    assert exc.value.code == 2
    assert "needs a CUDA device" in capsys.readouterr().err
    from sndepth_tpu_torch.utils.profiling import group_of
    assert group_of(
        "void (anonymous namespace)::gn_bwd_kernel<false, false>(float const*"
    ).startswith("K8b ")
    assert group_of("gn_bwd_kernel<true, true>").startswith("K8b ")
    assert group_of("gn_build_kernel(float").startswith("K8 ")


def test_kitti_submission_cli_says_that_data_parallel_waits(capsys):
    from sndepth_tpu_torch.cli import kitti_submission
    with pytest.raises(SystemExit) as exc:
        kitti_submission.main(["--data_parallel", "--device", "cpu"])
    assert exc.value.code != 0
    assert "not ported yet" in capsys.readouterr().err


@pytest.mark.parametrize("family", ["nnet", "motion", "vae"])
def test_benchmark_cli_refuses_families_that_are_not_ported(family, capsys):
    from sndepth_tpu_torch.cli import benchmark
    with pytest.raises(SystemExit) as exc:
        benchmark.main(["--family", family, "--device", "cpu"])
    assert exc.value.code != 0
    assert "not ported yet" in capsys.readouterr().err


def test_benchmark_cli_prints_one_json_line_per_family(capsys):
    import json
    from sndepth_tpu_torch.cli import benchmark
    results = benchmark.main(["--family", "all", "--batch", "1", "--iters",
                              "1", "--img_height", "64", "--img_width", "64",
                              "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines == results
    assert [r["family"] for r in results] == ["geonet", "flow", "raft3d"]
    for r in results:
        assert set(r) == {"family", "ms_per_step", "value", "unit"}
        assert r["unit"] == "frames/sec" and r["ms_per_step"] > 0
