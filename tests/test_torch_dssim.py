"""The port's DSSIM map (K7) on the CPU, where the wrappers take the
kernel's plain version, against the JAX Pallas kernel
(``sndepth_tpu.kernels.dssim.dssim_pallas`` in interpret mode) and against
the JAX split op (``sndepth_tpu.ops.ssim.dssim``): the map, dX and dY.

Tolerances: the map atol 1e-6 + rtol 1e-5 (nine-term float32 pool sums in
another order). Gradients atol 2e-4 + rtol 1e-3, the tolerance of the photo
kernel's adjoint, which is the same algebra: it divides by small SSIM
denominators, so float32 rounding is amplified.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sndepth_tpu.kernels.dssim import dssim_pallas
from sndepth_tpu.ops import ssim as jssim
from sndepth_tpu_torch.kernels import dssim as K7
from sndepth_tpu_torch.ops import ssim as tssim
from sndepth_tpu_torch.utils.layout import to_nchw, to_nhwc
from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield

VAL = dict(atol=1e-6, rtol=1e-5)
GRAD = dict(atol=2e-4, rtol=1e-3)
CASES = ("random", "equal_windows", "near_one", "half_equal")


def _case(kind, shape=(2, 9, 14, 3)):
    rng = np.random.RandomState(CASES.index(kind))
    x = (rng.rand(*shape) * 2 - 1).astype(np.float32)
    if kind == "random":
        y = (rng.rand(*shape) * 2 - 1).astype(np.float32)
    elif kind == "equal_windows":
        y = x.copy()                       # DSSIM exactly 0: the lower tie
    elif kind == "near_one":
        y = -x                             # drives the clip against 1
    else:
        y = x.copy()                       # ties on the left half only
        y[:, :, 7:] = (rng.rand(*y[:, :, 7:].shape) * 2 - 1)
    cot = (rng.rand(*shape) * 2 - 1).astype(np.float32)
    return x, y, cot


def _jax_all(fn, x, y, cot):
    out, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(y))
    dx, dy = vjp(jnp.asarray(cot))
    return np.asarray(out), np.asarray(dx), np.asarray(dy)


def _port_all(fn, x, y, cot):
    tx = torch.from_numpy(to_nchw(x)).requires_grad_(True)
    ty = torch.from_numpy(to_nchw(y)).requires_grad_(True)
    out = fn(tx, ty)
    (out * torch.from_numpy(to_nchw(cot))).sum().backward()
    for t in (out, tx.grad, ty.grad):
        assert torch.isfinite(t).all()
    return (to_nhwc(out.detach().numpy()), to_nhwc(tx.grad.numpy()),
            to_nhwc(ty.grad.numpy()))


def _compare(got, want):
    np.testing.assert_allclose(got[0], want[0], **VAL)
    np.testing.assert_allclose(got[1], want[1], **GRAD)
    np.testing.assert_allclose(got[2], want[2], **GRAD)


@pytest.mark.parametrize("kind", CASES)
def test_dssim_matches_jax_pallas_kernel(kind):
    x, y, cot = _case(kind)
    want = _jax_all(lambda a, b: dssim_pallas(a, b, True), x, y, cot)
    _compare(_port_all(tssim.dssim, x, y, cot), want)


@pytest.mark.parametrize("kind", CASES)
def test_dssim_matches_jax_split_op(kind):
    x, y, cot = _case(kind)
    want = _jax_all(jssim.dssim, x, y, cot)
    _compare(_port_all(tssim.dssim, x, y, cot), want)
    _compare(_port_all(tssim.dssim_reference, x, y, cot), want)


def test_equal_windows_take_half_the_gradient():
    """Where the windows are equal the map is exactly 0 and the clip passes
    half of the cotangent, as JAX's clip does."""
    x, _, cot = _case("equal_windows")
    out, dx, dy = _port_all(tssim.dssim, x, x.copy(), cot)
    assert (out == 0).all()
    _, jdx, jdy = _jax_all(jssim.dssim, x, x.copy(), cot)
    np.testing.assert_allclose(dx, jdx, **GRAD)
    np.testing.assert_allclose(dy, jdy, **GRAD)
    assert np.abs(dy).max() > 0


def test_anticorrelated_windows_reach_the_upper_clip_bound():
    """y = -x with window means near 0 drives (1 - SSIM) / 2 against 1, the
    clip's upper bound; SSIM >= -1 keeps it from passing it. Map and
    gradients follow JAX there as well."""
    rng = np.random.RandomState(12)
    x = np.sign(rng.rand(1, 12, 12, 1) - 0.5).astype(np.float32)
    y = -x
    cot = np.ones_like(x)
    out, dx, dy = _port_all(tssim.dssim, x, y, cot)
    jout, jdx, jdy = _jax_all(jssim.dssim, x, y, cot)
    np.testing.assert_allclose(out, jout, **VAL)
    assert out.max() > 0.9 and out.max() <= 1.0 and out.min() >= 0.0
    np.testing.assert_allclose(dx, jdx, **GRAD)
    np.testing.assert_allclose(dy, jdy, **GRAD)


def test_image_similarity_matches_jax():
    x, y, cot = _case("random")
    want = _jax_all(lambda a, b: jssim.image_similarity(0.85, a, b), x, y, cot)
    for fn in (tssim.image_similarity, tssim.image_similarity_reference):
        _compare(_port_all(lambda a, b: fn(0.85, a, b), x, y, cot), want)


@pytest.mark.parametrize("need", [(True, False), (False, True), (False, False)])
def test_backward_skips_the_side_that_wants_no_gradient(need):
    x, y, cot = (torch.from_numpy(to_nchw(a)) for a in _case("random"))
    dx, dy = K7.dssim_backward(x, y, cot)
    got = K7.dssim_backward(x, y, cot, *need)
    for g, full, wanted in zip(got, (dx, dy), need):
        if wanted:
            torch.testing.assert_close(g, full, rtol=0, atol=0)
        else:
            assert g is None
    tx = x.clone().requires_grad_(need[0])
    ty = y.clone().requires_grad_(need[1])
    out = tssim.dssim(tx, ty)
    assert out.requires_grad == any(need)


@pytest.mark.parametrize("bad", ["dtype", "layout", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, y = torch.zeros(2, 3, 6, 8), torch.zeros(2, 3, 6, 8)
    if bad == "dtype":
        y = y.double()
    elif bad == "layout":
        y = y.transpose(-1, -2).contiguous().transpose(-1, -2)
    else:
        y = torch.zeros(2, 3, 6, 7)
    with pytest.raises((TypeError, ValueError)):
        K7.dssim_forward(x, y)
