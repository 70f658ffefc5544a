"""The port's pair photo loss (K1) on the CPU, where it takes its plain
version, against the JAX pair kernel itself (run by the Pallas interpreter
on the CPU) and against the JAX split path (``flow_warp`` +
``image_similarity``), on loss and coordinate gradients.

Tolerances: loss rtol 2e-5 (float32 sums of ~10^4 terms in different
orders, as ``tests/test_photo_loss.py``); gradients atol 2e-4 + rtol 1e-3,
the JAX kernel's own tolerance against its split ops: the DSSIM adjoint
divides by small SSIM denominators, so float32 rounding is amplified.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sndepth_tpu.kernels.photo_loss import warp_photo_pair_loss as jax_pair
from sndepth_tpu.ops.ssim import image_similarity as jax_sim
from sndepth_tpu.ops.warp import bilinear_sampler as jax_sampler
from sndepth_tpu_torch.kernels import photo_loss as K1
from sndepth_tpu_torch.utils.layout import to_nchw, to_nhwc

ALPHA = 0.85
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)


def _case(seed, b=2, ns=2, h=16, w=40, spread=1.5):
    """NHWC numpy inputs: tgt, srcs, and coords = grid + noise."""
    rng = np.random.RandomState(seed)
    tgt = (rng.rand(b, h, w, 3) * 2 - 1).astype(np.float32)
    srcs = (rng.rand(b, ns, h, w, 3) * 2 - 1).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    grid = np.stack([xs, ys], -1)[None, None]
    cf = (grid + rng.uniform(-spread, spread, (b, ns, h, w, 2))
          ).astype(np.float32)
    cb = (grid + rng.uniform(-spread, spread, (b, ns, h, w, 2))
          ).astype(np.float32)
    return tgt, srcs, cf, cb


def _split_ref(tgt, srcs, cf, cb):
    """JAX split ops: sum of both directions' error maps (NHWC)."""
    b, ns, h, w, c = srcs.shape
    tt = jnp.broadcast_to(tgt[:, None], srcs.shape).reshape(b * ns, h, w, c)
    sf = srcs.reshape(b * ns, h, w, c)
    fwd = jax_sampler(sf, cf.reshape(b * ns, h, w, 2))
    bwd = jax_sampler(tt, cb.reshape(b * ns, h, w, 2))
    return (jnp.sum(jax_sim(ALPHA, tt, fwd))
            + jnp.sum(jax_sim(ALPHA, sf, bwd)))


def _jax_pair(tgt, srcs, cf, cb):
    return jax_pair(tgt, srcs, cf, cb, ALPHA, "edge_zero")


def _port(tgt, srcs, cf, cb):
    """Port on the CPU: 0.37 * loss and its (d cf, d cb), back in NHWC."""
    t = [torch.from_numpy(to_nchw(a)) for a in (tgt, srcs, cf, cb)]
    cf_t = t[2].requires_grad_(True)
    cb_t = t[3].requires_grad_(True)
    loss = 0.37 * K1.warp_photo_pair_loss(t[0], t[1], cf_t, cb_t, ALPHA)
    loss.backward()
    g = (to_nhwc(cf_t.grad.numpy()), to_nhwc(cb_t.grad.numpy()))
    for a in g:
        assert np.isfinite(a).all()
    return float(loss.detach()), g


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(fn):
    """One compiled value-and-grad per JAX function, shared by the cases."""
    return jax.jit(jax.value_and_grad(
        lambda t, s, a, b: 0.37 * fn(t, s, a, b), argnums=(2, 3)))


def _jax(fn, tgt, srcs, cf, cb):
    loss, g = _jax_value_and_grad(fn)(tgt, srcs, cf, cb)
    return float(loss), [np.asarray(a) for a in g]


CASES = {
    "small_flow": dict(seed=0),
    "wild_out_of_image": dict(seed=1, spread=30.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pair_loss_matches_jax_pair_kernel(case):
    args = _case(**CASES[case])
    want, (wf, wb) = _jax(_jax_pair, *args)
    got, (gf, gb) = _port(*args)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    np.testing.assert_allclose(gf, wf, **GRAD_TOL)
    np.testing.assert_allclose(gb, wb, **GRAD_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pair_loss_matches_jax_split_ops(case):
    args = _case(**CASES[case])
    want, (wf, wb) = _jax(_split_ref, *args)
    got, (gf, gb) = _port(*args)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    np.testing.assert_allclose(gf, wf, **GRAD_TOL)
    np.testing.assert_allclose(gb, wb, **GRAD_TOL)


def test_images_get_no_gradient():
    tgt, srcs, cf, cb = (torch.from_numpy(to_nchw(a)) for a in _case(3))
    tgt.requires_grad_(True)
    cf.requires_grad_(True)
    K1.warp_photo_pair_loss(tgt, srcs, cf, cb, ALPHA).backward()
    assert tgt.grad is None
    assert cf.grad is not None and torch.isfinite(cf.grad).all()


def test_equal_windows_take_the_clip_tie():
    """Sources equal to the target, warped at the identity grid: DSSIM is
    exactly 0 on the interior, where the clip's gradient splits 0.5/0.5,
    and |x - y| is 0, where the L1 derivative is sign(0) = 0. The JAX pair
    kernel follows both rules (the JAX split ops' abs takes +1 at 0)."""
    tgt, _, cf, _ = _case(4)
    srcs = np.repeat(tgt[:, None], cf.shape[1], 1)
    grid = np.broadcast_to(
        np.stack(np.mgrid[0:cf.shape[2], 0:cf.shape[3]][::-1], -1),
        cf.shape).astype(np.float32)
    args = (tgt, srcs, grid.copy(), grid.copy())
    want, (wf, wb) = _jax(_jax_pair, *args)
    got, (gf, gb) = _port(*args)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    np.testing.assert_allclose(gf, wf, **GRAD_TOL)
    np.testing.assert_allclose(gb, wb, **GRAD_TOL)


@pytest.mark.parametrize("bad", ["dtype", "layout", "channels"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    tgt, srcs, cf, cb = (torch.from_numpy(to_nchw(a)) for a in _case(5))
    if bad == "dtype":
        tgt = tgt.double()
    elif bad == "layout":
        cf = cf.transpose(-1, -2).contiguous().transpose(-1, -2)
    else:
        tgt, srcs = tgt[:, :2].contiguous(), srcs[:, :, :2].contiguous()
    with pytest.raises((TypeError, ValueError)):
        K1.photo_pair_sums(tgt, srcs, cf, cb, ALPHA)
