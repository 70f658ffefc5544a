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
from sndepth_tpu_torch.utils import tracing
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
    train step, the GeoNet -> NNET -> RAFT3D prediction, the RAFT3D demo,
    the fused prediction with RAFT2D-Large flow, the VAE smoke test, the
    GeoNet -> NNET -> VAE -> UniAD pipeline, a UniAD train step, the
    parity report and the CLIs run (so the imports inside functions run
    too), with JAX and the JAX package blocked."""
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
                 "cli.predict_raft3d", "utils.profiling", "models.motionseg",
                 "losses.segmentation", "losses.normal_loss", "train.motion",
                 "train.nnet", "data.kitti_motion", "cli.predict",
                 "cli.predict_motion", "cli.evaluate_motion",
                 "cli.train_motion", "cli.train_nnet", "models.raft2d",
                 "cli.demo", "models.vae", "models.attention",
                 "models.denoiser", "models.vit", "utils.diffusion",
                 "ops.layers", "cli.predict_vae", "cli.testvae",
                 "utils.uniad", "ops.box_iou", "models.deformable",
                 "models.bevformer", "models.track_head",
                 "models.track_runtime", "models.coders",
                 "models.uniad_track", "losses.lap", "losses.track_loss",
                 "train.uniad", "cli.predict_vae_uniad", "cli.train_uniad",
                 "parallel.multihost", "parallel.mesh", "parallel.fsdp",
                 "parallel.tensor_parallel", "parallel.sequence_parallel",
                 "parallel.pipeline", "train.checkpoint", "serving.export",
                 "cli.export_model", "cli.convert_weights",
                 "cli.parity_report", "cli.image_split",
                 "models.dispnet_alt", "data.custom"):
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
            "from sndepth_tpu_torch.cli import demo, predict, testvae\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    demo.main(['--iters', '1', '--device', 'cpu',\n"
            "               '--out', d + '/demo.png'])\n"
            "    predict.main(['--synthetic', '--flow_source', 'raft2d_large',\n"
            "                  '--raft2d_iters', '1', '--img_height', '64',\n"
            "                  '--img_width', '64', '--out_dir', d,\n"
            "                  '--device', 'cpu'])\n"
            "testvae.main(['--batch', '1', '--height', '32', '--width', '32',\n"
            "              '--device', 'cpu'])\n"
            "from sndepth_tpu_torch.cli import predict_vae_uniad, train_uniad\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    predict_vae_uniad.main(['--frames', '1', '--out_dir', d,\n"
            "                            '--device', 'cpu'])\n"
            "    state, _ = train_uniad.main(\n"
            "        ['--small', '--max_steps', '1', '--t_frames', '2',\n"
            "         '--ckpt_dir', d + '/u', '--device', 'cpu'])\n"
            "    assert state.step == 1\n"
            "from sndepth_tpu_torch.cli import parity_report\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    parity_report.main(['--checkpoints_dir', d, '--data_dir', d,\n"
            "                        '--out_dir', d + '/report'])\n"
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
    counts = tracing.counts()
    assert sorted(counts) == sorted(tracing.COUNTERS) and len(counts) == 14
    return counts


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


def test_kitti_submission_cli_says_that_data_parallel_waits(capsys,
                                                           tmp_path):
    """``--data_parallel`` no longer waits: without a process group it is
    the one-process run (here on an empty tree: nothing to do)."""
    from sndepth_tpu_torch.cli import kitti_submission
    assert kitti_submission.main(["--data_parallel", "--device", "cpu",
                                  "--root", str(tmp_path)]) == 0
    out = capsys.readouterr()
    assert "nothing to do" in out.out and "not ported yet" not in out.err


def test_benchmark_cli_accepts_every_family_of_the_jax_cli(capsys):
    """The port's ``--family`` choices are the JAX CLI's: each one parses
    (the run then stops at ``--iters 0``, which is refused after parsing)."""
    from sndepth_tpu.cli import benchmark as jbenchmark
    from sndepth_tpu_torch.cli import benchmark
    with pytest.raises(SystemExit):
        jbenchmark.main(["--family", "no_such_family"])
    err = capsys.readouterr().err
    jax_choices = set(re.findall(
        r"\w+", err.split("choose from")[1].split(")")[0]))
    assert jax_choices == {"all", *benchmark.FAMILIES}
    for family in sorted(jax_choices):
        with pytest.raises(SystemExit) as exc:
            benchmark.main(["--family", family, "--iters", "0",
                            "--device", "cpu"])
        assert exc.value.code == 2
        assert "--iters must be at least 1" in capsys.readouterr().err


def test_benchmark_cli_prints_one_json_line_per_family(capsys):
    import json
    from sndepth_tpu_torch.cli import benchmark
    results = benchmark.main(["--family", "all", "--batch", "1", "--iters",
                              "1", "--img_height", "64", "--img_width", "64",
                              "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines == results
    assert [r["family"] for r in results] == ["geonet", "flow", "nnet",
                                              "motion", "vae", "raft3d"]
    for r in results:
        assert set(r) == {"family", "ms_per_step", "value", "unit"}
        assert r["ms_per_step"] > 0
        assert r["unit"] == ("img/sec" if r["family"] in ("nnet", "motion",
                                                          "vae")
                             else "frames/sec")


@pytest.mark.parametrize("cli", ["train_motion", "train_nnet", "predict",
                                 "predict_motion", "demo", "predict_vae",
                                 "testvae", "predict_vae_uniad",
                                 "train_uniad"])
def test_motion_and_nnet_clis_default_device_needs_a_card(cli, tmp_path):
    """Without ``--device`` the new CLIs run on the card: without one they
    raise and write nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import importlib

    import numpy as np
    from PIL import Image
    main = importlib.import_module(f"sndepth_tpu_torch.cli.{cli}").main
    out = tmp_path / "out"
    argv = {
        "train_motion": ["--max_steps", "1", "--batch_size", "1",
                         "--height", "32", "--width", "64", "--data_dir",
                         str(tmp_path / "none"), "--ckpt_dir", str(out)],
        "train_nnet": ["--max_steps", "1", "--batch_size", "1",
                       "--img_height", "32", "--img_width", "64",
                       "--ckpt_dir", str(out)],
        "predict": ["--synthetic", "--img_height", "32", "--img_width", "64",
                    "--out_dir", str(out)],
        "predict_motion": [str(tmp_path / "i.png"), str(tmp_path / "i.png"),
                           "--ckpt_dir", str(tmp_path / "none"), "--out",
                           str(out)],
        "demo": ["--iters", "1", "--out", str(out / "demo.png")],
        "predict_vae": ["--img_height", "32", "--img_width", "64",
                        "--out_dir", str(out)],
        "testvae": ["--batch", "1", "--height", "32", "--width", "32"],
        "predict_vae_uniad": ["--frames", "1", "--out_dir", str(out)],
        "train_uniad": ["--small", "--max_steps", "1", "--ckpt_dir",
                        str(out)],
    }[cli]
    Image.fromarray(np.zeros((20, 30, 3), np.uint8)).save(tmp_path / "i.png")
    with pytest.raises((AssertionError, RuntimeError)):
        main(argv)
    assert not out.exists()


def test_profile_step_knows_the_uniad_families_and_the_sampler_kernels(
        capsys):
    """``--family uniad|uniad_train`` parse and need the card; the profile
    groups the gather's coordinate gradient (K5b) and both splat kernels
    (K6) apart."""
    from sndepth_tpu_torch.cli import profile_step
    from sndepth_tpu_torch.utils.profiling import group_of
    if not torch.cuda.is_available():
        for family in ("uniad", "uniad_train"):
            with pytest.raises(SystemExit) as exc:
                profile_step.main(["--family", family])
            assert exc.value.code == 2
            assert "needs a CUDA device" in capsys.readouterr().err
    assert group_of("void (anonymous namespace)::warp_coord_grad_kernel<1, "
                    "2, 0>(float const*").startswith("K5b ")
    assert group_of("warp_splat_plane_kernel<1>").startswith("K6 ")
    assert group_of("warp_splat_kernel<1>").startswith("K6 ")
    assert group_of("warp_gather_kernel<1, 4, 0>").startswith("K5 ")


def _spy_sampler(monkeypatch) -> dict:
    """Count the calls of the sampler kernels' wrappers (each launches and
    counts its kernel on a CUDA tensor; here their plain versions run)."""
    calls = {"warp_gather": 0, "warp_coord_grad": 0, "warp_splat": 0}
    for name in calls:
        real = getattr(K5, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(K5, name, spy)
    return calls


def test_uniad_paths_go_through_the_sampler_kernels(monkeypatch):
    """A UniAD frame samples through K5's wrapper once for each deformable
    attention level and layer, each DCN 3x3 and the BEV shift; a train step
    once more for each recomputed attention with ``remat``, and through
    K5b's and K6's once for each forward call (the counts ``chip_smoke.py``
    holds at the reference config)."""
    from sndepth_tpu_torch.cli.train_uniad import small_model
    from sndepth_tpu_torch.models import uniad_track as ut
    from sndepth_tpu_torch.train import uniad as tu
    calls = _spy_sampler(monkeypatch)
    model = small_model()                  # 1 + 2 layers, 2 DCN blocks
    ut.init_weights(model, torch.Generator().manual_seed(0))
    imgs = torch.rand(2, 1, 3, 64, 64)
    l2i = torch.eye(4).expand(1, 2, 4, 4)
    with torch.no_grad():
        state, _ = model(imgs, l2i, model.init_state())
        model(imgs, l2i, state, ego_shift=torch.tensor([[0.1, 0.0]]))
    per_frame = 4 * 1 + 1 + 2 + 2          # SCA, TSA, decoder, DCN
    assert calls == {"warp_gather": 2 * per_frame + 1, "warp_coord_grad": 0,
                     "warp_splat": 0}
    for remat, recomputed in ((False, 0), (True, 4 + 1 + 2)):
        calls.update({k: 0 for k in calls})
        model = small_model(remat=remat)
        ut.init_weights(model, torch.Generator().manual_seed(0))
        clip = tu.synthetic_clip(model, t_frames=2, ng=3, img_hw=(64, 64))
        tu.train_step(tu.create_train_state(model, "cpu"), clip)
        assert calls == {"warp_gather": 2 * (per_frame + recomputed),
                         "warp_coord_grad": 2 * per_frame,
                         "warp_splat": 2 * per_frame}
