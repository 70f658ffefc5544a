"""The port's photo losses (K1 pair, K3 single direction, K4 weighted pair)
on the CPU, where they take their plain version, against the JAX kernels
themselves (run by the Pallas interpreter on the CPU) and against the JAX
split path (``flow_warp`` + ``image_similarity``), on loss and coordinate
gradients.

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

from sndepth_tpu.kernels.photo_loss import warp_photo_loss as jax_single
from sndepth_tpu.kernels.photo_loss import warp_photo_pair_loss as jax_pair
from sndepth_tpu.kernels.photo_loss import (
    warp_photo_pair_loss_weighted as jax_pair_weighted)
from sndepth_tpu.ops.ssim import image_similarity as jax_sim
from sndepth_tpu.ops.warp import bilinear_sampler as jax_sampler
from sndepth_tpu_torch.kernels import photo_loss as K1
from sndepth_tpu_torch.utils.layout import to_nchw, to_nhwc
from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield

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


def _single_case(seed, spread=1.5):
    """One direction for one source: tgt, src (B, H, W, 3), coords."""
    tgt, srcs, cf, _ = _case(seed, ns=1, spread=spread)
    return tgt, srcs[:, 0], cf[:, 0]


def _port_single(tgt, src, coords):
    t = [torch.from_numpy(to_nchw(a)) for a in (tgt, src, coords)]
    c = t[2].requires_grad_(True)
    loss = 0.37 * K1.warp_photo_loss(t[0], t[1], c, ALPHA)
    loss.backward()
    assert torch.isfinite(c.grad).all()
    return float(loss.detach()), to_nhwc(c.grad.numpy())


def _jax_single(t, s, c):
    return jax_single(t, s, c, ALPHA, "edge_zero")


def _split_single(t, s, c):
    return jnp.sum(jax_sim(ALPHA, t, jax_sampler(s, c)))


@functools.lru_cache(maxsize=None)
def _jax_single_value_and_grad(fn):
    """One compiled value-and-grad in the coordinates per JAX function."""
    return jax.jit(jax.value_and_grad(
        lambda t, s, c: 0.37 * fn(t, s, c), argnums=2))


@pytest.mark.parametrize("case", sorted(CASES))
def test_single_loss_matches_jax_kernel_and_split_ops(case):
    """K3 against ``warp_photo_loss`` and against the JAX split ops."""
    tgt, src, coords = _single_case(**CASES[case])
    got, g = _port_single(tgt, src, coords)
    for fn in (_jax_single, _split_single):
        want, wg = _jax_single_value_and_grad(fn)(tgt, src, coords)
        np.testing.assert_allclose(got, float(want), rtol=2e-5)
        np.testing.assert_allclose(g, np.asarray(wg), **GRAD_TOL)


def test_two_single_losses_equal_the_pair_loss():
    """K3 forward plus K3 backward is K1 for one source."""
    tgt, srcs, cf, cb = _case(6, ns=1)
    pair, (gf, gb) = _port(tgt, srcs, cf, cb)
    fwd, g_fwd = _port_single(tgt, srcs[:, 0], cf[:, 0])
    bwd, g_bwd = _port_single(srcs[:, 0], tgt, cb[:, 0])
    np.testing.assert_allclose(fwd + bwd, pair, rtol=1e-6)
    np.testing.assert_allclose(g_fwd, gf[:, 0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g_bwd, gb[:, 0], rtol=1e-6, atol=1e-7)


def _weights(seed, shape, kind):
    rng = np.random.RandomState(seed)
    if kind == "masks":               # what stage 2 passes: {0, 0.5, 1}
        return [(rng.randint(0, 3, shape) * 0.5).astype(np.float32)
                for _ in range(2)]
    return [rng.rand(*shape).astype(np.float32) for _ in range(2)]


def _port_weighted(tgt, srcs, cf, cb, wf, wb):
    t = [torch.from_numpy(to_nchw(a)) for a in (tgt, srcs, cf, cb)]
    cf_t = t[2].requires_grad_(True)
    cb_t = t[3].requires_grad_(True)
    wf_t = torch.from_numpy(wf).requires_grad_(True)
    wb_t = torch.from_numpy(wb).requires_grad_(True)
    loss = 0.37 * K1.warp_photo_pair_loss_weighted(t[0], t[1], cf_t, cb_t,
                                                   wf_t, wb_t, ALPHA)
    loss.backward()
    assert wf_t.grad is None and wb_t.grad is None
    g = (to_nhwc(cf_t.grad.numpy()), to_nhwc(cb_t.grad.numpy()))
    for a in g:
        assert np.isfinite(a).all()
    return float(loss.detach()), g


def _split_weighted(tgt, srcs, cf, cb, wf, wb):
    b, ns, h, w, c = srcs.shape
    tt = jnp.broadcast_to(tgt[:, None], srcs.shape).reshape(b * ns, h, w, c)
    sf = srcs.reshape(b * ns, h, w, c)
    fwd = jax_sampler(sf, cf.reshape(b * ns, h, w, 2))
    bwd = jax_sampler(tt, cb.reshape(b * ns, h, w, 2))
    return (jnp.sum(jax_sim(ALPHA, tt, fwd) * wf.reshape(b * ns, h, w, 1))
            + jnp.sum(jax_sim(ALPHA, sf, bwd) * wb.reshape(b * ns, h, w, 1)))


def _jax_weighted(tgt, srcs, cf, cb, wf, wb):
    return jax_pair_weighted(tgt, srcs, cf, cb, wf, wb, ALPHA, "edge_zero")


@functools.lru_cache(maxsize=None)
def _jax_weighted_value_and_grad(fn):
    """One compiled value-and-grad in both coordinate sets per JAX
    function, shared by the cases of one shape."""
    return jax.jit(jax.value_and_grad(
        lambda t, s, a, b, wf, wb: 0.37 * fn(t, s, a, b, wf, wb),
        argnums=(2, 3)))


@pytest.mark.parametrize("kind", ["masks", "random"])
@pytest.mark.parametrize("ns", [1, 2])
def test_weighted_pair_loss_matches_jax_kernel_and_split_ops(ns, kind):
    """K4 against ``warp_photo_pair_loss_weighted`` and the split ops; the
    weights get no gradient."""
    tgt, srcs, cf, cb = _case(7 + ns, ns=ns)
    wf, wb = _weights(ns, cf.shape[:-1], kind)
    got, (gf, gb) = _port_weighted(tgt, srcs, cf, cb, wf, wb)
    for fn in (_jax_weighted, _split_weighted):
        want, (wgf, wgb) = _jax_weighted_value_and_grad(fn)(
            tgt, srcs, cf, cb, wf, wb)
        np.testing.assert_allclose(got, float(want), rtol=2e-5)
        np.testing.assert_allclose(gf, np.asarray(wgf), **GRAD_TOL)
        np.testing.assert_allclose(gb, np.asarray(wgb), **GRAD_TOL)


def test_weights_of_one_equal_the_pair_loss():
    tgt, srcs, cf, cb = _case(10)
    ones = np.ones(cf.shape[:-1], np.float32)
    pair, (gf, gb) = _port(tgt, srcs, cf, cb)
    got, (wgf, wgb) = _port_weighted(tgt, srcs, cf, cb, ones, ones)
    np.testing.assert_allclose(got, pair, rtol=1e-6)
    np.testing.assert_allclose(wgf, gf, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(wgb, gb, rtol=1e-6, atol=1e-7)


def test_plain_versions_call_only_plain_versions(monkeypatch):
    """On a card the public samplers and DSSIM launch kernels, so the plain
    photo loss must not reach them."""
    from sndepth_tpu_torch.kernels import dssim as K7
    from sndepth_tpu_torch.kernels import warp as K5

    def boom(*args, **kwargs):
        raise AssertionError("a plain version reached a kernel wrapper")

    for mod, name in ((K5, "warp_gather"), (K5, "warp_coord_grad"),
                      (K5, "warp_splat"),
                      (K7, "dssim_forward"), (K7, "dssim_backward")):
        monkeypatch.setattr(mod, name, boom)
    tgt, srcs, cf, cb = (torch.from_numpy(to_nchw(a)) for a in _case(11))
    wf = torch.ones(cf.shape[0], cf.shape[1], *cf.shape[3:])
    K1.photo_pair_sums_reference(tgt, srcs, cf, cb, ALPHA)
    K1.photo_pair_sums_reference(tgt, srcs, cf, cb, ALPHA, wf, wf)
    K1.photo_sums_reference(tgt, srcs[:, 0].contiguous(),
                            cf[:, 0].contiguous(), ALPHA)
