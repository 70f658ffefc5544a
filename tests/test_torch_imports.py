"""The port imports without JAX, and a kernel request that cannot run on
the card raises instead of falling back to the plain version."""

import pkgutil
import subprocess
import sys

import pytest
import torch

import sndepth_tpu_torch
from sndepth_tpu_torch.kernels import photo_loss as K1
from sndepth_tpu_torch.kernels import smooth_loss as K2


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        sndepth_tpu_torch.__path__, "sndepth_tpu_torch."))


def test_every_module_imports_with_jax_unavailable():
    names = _modules()
    assert "sndepth_tpu_torch.cli.train_geonet" in names
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'optax')\n"
            "       and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _photo_inputs(device="cpu"):
    b, ns, h, w = 1, 2, 8, 12
    return (torch.zeros(b, 3, h, w, device=device),
            torch.zeros(b, ns, 3, h, w, device=device),
            torch.zeros(b, ns, 2, h, w, device=device),
            torch.zeros(b, ns, 2, h, w, device=device))


def _smooth_inputs(device="cpu"):
    return (torch.ones(2, 1, 8, 12, device=device),
            torch.zeros(2, 3, 8, 12, device=device))


def test_kernel_launch_without_a_card_raises():
    """The launch path (what a CUDA tensor takes) needs nvcc or triton and
    the card; without them it raises rather than computing anything."""
    n1, n2 = K1.photo_pair_sums.launches, K2.smooth_sums.launches
    with pytest.raises((RuntimeError, OSError)):
        K1._launch(*_photo_inputs(), 0.85)
    with pytest.raises(ImportError):
        K2._launch(*_smooth_inputs())
    assert (K1.photo_pair_sums.launches, K2.smooth_sums.launches) == (n1, n2)


def test_other_devices_raise_rather_than_fall_back():
    with pytest.raises(ValueError):
        K1.photo_pair_sums(*_photo_inputs("meta"), 0.85)
    with pytest.raises(ValueError):
        K2.smooth_sums(*_smooth_inputs("meta"))


def test_cpu_tensors_take_the_plain_versions_without_counting():
    n1, n2 = K1.photo_pair_sums.launches, K2.smooth_sums.launches
    loss, d_cf, d_cb = K1.photo_pair_sums(*_photo_inputs(), 0.85)
    sx, sy, ddx, ddy = K2.smooth_sums(*_smooth_inputs())
    assert d_cf.shape == (1, 2, 2, 8, 12) and ddx.shape == (2, 1, 8, 12)
    assert float(sx) == 0.0 and float(sy) == 0.0
    assert (K1.photo_pair_sums.launches, K2.smooth_sums.launches) == (n1, n2)


def test_cli_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from sndepth_tpu_torch.cli import train_geonet
    with pytest.raises((AssertionError, RuntimeError)):
        train_geonet.main(["--max_steps", "1", "--batch_size", "1",
                           "--img_height", "32", "--img_width", "64",
                           "--ckpt_dir", str(tmp_path / "ckpt"),
                           "--graphs_dir", str(tmp_path / "logs")])
