"""The port's ops (pyramid, camera, edge_zero warp, SSIM) against
``sndepth_tpu.ops`` on the same numpy inputs: values, and gradients by
``torch.autograd`` against ``jax.grad``.

Tolerances: values rtol 1e-5/atol 1e-6 (float32, same formulas, possibly
other summation orders); gradients atol 1e-5 + rtol 1e-4 except where
stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sndepth_tpu.ops import camera as jcam
from sndepth_tpu.ops import pyramid as jpyr
from sndepth_tpu.ops import ssim as jssim
from sndepth_tpu.ops import warp as jwarp
from sndepth_tpu_torch.ops import camera as tcam
from sndepth_tpu_torch.ops import pyramid as tpyr
from sndepth_tpu_torch.ops import ssim as tssim
from sndepth_tpu_torch.ops import warp as twarp
from sndepth_tpu_torch.utils.layout import to_nchw, to_nhwc

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _img(seed, shape):
    return (np.random.RandomState(seed).rand(*shape) * 2 - 1).astype(
        np.float32)


def _finite(*arrays):
    for a in arrays:
        assert np.isfinite(np.asarray(a)).all()


@pytest.mark.parametrize("hw", [(16, 40), (9, 13)])
def test_pyramid_and_gradients_match_jax(hw):
    x = _img(0, (2,) + hw + (3,))
    want = jpyr.scale_pyramid(jnp.asarray(x), 3)
    got = tpyr.scale_pyramid(torch.from_numpy(to_nchw(x)), 3)
    for w_, g_ in zip(want, got):
        np.testing.assert_allclose(to_nhwc(g_.numpy()), np.asarray(w_), **VAL)
    t = torch.from_numpy(to_nchw(x))
    np.testing.assert_allclose(to_nhwc(tpyr.gradient_x(t).numpy()),
                               np.asarray(jpyr.gradient_x(jnp.asarray(x))))
    np.testing.assert_allclose(to_nhwc(tpyr.gradient_y(t).numpy()),
                               np.asarray(jpyr.gradient_y(jnp.asarray(x))))


def _camera_case(seed, b=2, h=8, w=12):
    rng = np.random.RandomState(seed)
    pose = (rng.randn(b, 6) * [0.1, 0.1, 0.1, 0.05, 0.05, 0.05]).astype(
        np.float32)
    depth = (rng.rand(b, h, w) * 10 + 1).astype(np.float32)
    k = np.tile(np.array([[[w * 0.6, 0, w / 2], [0, h * 1.8, h / 2],
                           [0, 0, 1]]], np.float32), (b, 1, 1))
    k *= rng.uniform(0.9, 1.1, (b, 3, 3)).astype(np.float32)
    return pose, depth, k


@pytest.mark.parametrize("reverse", [False, True])
def test_rigid_flow_and_its_gradients_match_jax(reverse):
    pose, depth, k = _camera_case(1)
    want = jcam.compute_rigid_flow(jnp.asarray(pose), jnp.asarray(depth),
                                   jnp.asarray(k), reverse)
    cot = _img(2, want.shape)
    jgp, jgd = jax.grad(
        lambda p, d: jnp.sum(jcam.compute_rigid_flow(p, d, jnp.asarray(k),
                                                     reverse) * cot),
        argnums=(0, 1))(jnp.asarray(pose), jnp.asarray(depth))

    p = torch.from_numpy(pose).requires_grad_(True)
    d = torch.from_numpy(depth).requires_grad_(True)
    got = tcam.compute_rigid_flow(p, d, torch.from_numpy(k), reverse)
    (got * torch.from_numpy(to_nchw(cot))).sum().backward()
    _finite(p.grad, d.grad)
    np.testing.assert_allclose(to_nhwc(got.detach().numpy()),
                               np.asarray(want), rtol=1e-5, atol=1e-4)
    # The pose gradient sums ~10^2 per-pixel terms of both signs.
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jgd), **GRAD)


def test_camera_helpers_match_jax():
    pose, depth, k = _camera_case(3)
    np.testing.assert_allclose(
        tcam.pose_vec2mat(torch.from_numpy(pose)).numpy(),
        np.asarray(jcam.pose_vec2mat(jnp.asarray(pose))), **VAL)
    m = jcam.pose_vec2mat(jnp.asarray(pose))
    np.testing.assert_allclose(
        tcam.invert_pose_mat(torch.from_numpy(np.array(m))).numpy(),
        np.asarray(jcam.invert_pose_mat(m)), **VAL)
    np.testing.assert_allclose(
        tcam.invert_intrinsics(torch.from_numpy(k)).numpy(),
        np.asarray(jcam.invert_intrinsics(jnp.asarray(k))), **VAL)
    np.testing.assert_allclose(
        tcam.compute_multi_scale_intrinsics(torch.from_numpy(k), 4).numpy(),
        np.asarray(jcam.compute_multi_scale_intrinsics(jnp.asarray(k), 4)),
        **VAL)
    np.testing.assert_allclose(tcam.meshgrid(5, 7).numpy(),
                               np.asarray(jcam.meshgrid(5, 7)))


@pytest.mark.parametrize("spread", [1.5, 30.0])
def test_edge_zero_warp_and_gradients_match_jax(spread):
    """spread 30 puts most coordinates far outside the image, where every
    edge_zero weight is 0 but the coordinate derivative is still formed."""
    rng = np.random.RandomState(4)
    imgs = _img(5, (2, 10, 14, 3))
    ys, xs = np.mgrid[0:10, 0:14].astype(np.float32)
    coords = (np.stack([xs, ys], -1)[None]
              + rng.uniform(-spread, spread, (2, 10, 14, 2))).astype(
                  np.float32)
    cot = _img(6, (2, 10, 14, 3))
    want = jwarp.bilinear_sampler(jnp.asarray(imgs), jnp.asarray(coords))
    jgi, jgc = jax.grad(lambda i, c: jnp.sum(
        jwarp.bilinear_sampler(i, c) * cot), argnums=(0, 1))(
            jnp.asarray(imgs), jnp.asarray(coords))

    ti = torch.from_numpy(to_nchw(imgs)).requires_grad_(True)
    tc = torch.from_numpy(to_nchw(coords)).requires_grad_(True)
    got = twarp.bilinear_sampler(ti, tc)
    (got * torch.from_numpy(to_nchw(cot))).sum().backward()
    _finite(ti.grad, tc.grad)
    np.testing.assert_allclose(to_nhwc(got.detach().numpy()),
                               np.asarray(want), **VAL)
    np.testing.assert_allclose(to_nhwc(ti.grad.numpy()), np.asarray(jgi),
                               **GRAD)
    np.testing.assert_allclose(to_nhwc(tc.grad.numpy()), np.asarray(jgc),
                               **GRAD)


def test_flow_warp_matches_jax_and_zeroes_last_column():
    img = _img(7, (1, 6, 9, 3))
    flow = np.zeros((1, 6, 9, 2), np.float32)
    want = np.asarray(jwarp.flow_warp(jnp.asarray(img), jnp.asarray(flow)))
    got = to_nhwc(twarp.flow_warp(torch.from_numpy(to_nchw(img)),
                                  torch.from_numpy(to_nchw(flow))).numpy())
    np.testing.assert_allclose(got, want, **VAL)
    assert (got[:, -1] == 0).all() and (got[:, :, -1] == 0).all()
    np.testing.assert_array_equal(got[:, :-1, :-1], img[:, :-1, :-1])


def test_nan_coordinates_sample_nan_without_an_index_error():
    img = torch.from_numpy(to_nchw(_img(8, (1, 4, 5, 3))))
    coords = torch.full((1, 2, 4, 5), float("nan"))
    assert torch.isnan(twarp.bilinear_sampler(img, coords)).all()


@pytest.mark.parametrize("case", ["random", "equal_windows", "near_one"])
def test_dssim_and_similarity_gradients_match_jax(case):
    """'equal_windows' makes DSSIM exactly 0 (the clip's lower tie, where
    JAX splits the gradient 0.5/0.5); 'near_one' drives it against 1."""
    x = _img(9, (2, 8, 11, 3))
    if case == "random":
        y = _img(10, x.shape)
    elif case == "equal_windows":
        y = x.copy()
    else:
        y = -x
    cot = _img(11, x.shape)
    want = jssim.dssim(jnp.asarray(x), jnp.asarray(y))
    jg = jax.grad(lambda b: jnp.sum(jssim.dssim(jnp.asarray(x), b) * cot))(
        jnp.asarray(y))
    ty = torch.from_numpy(to_nchw(y)).requires_grad_(True)
    got = tssim.dssim(torch.from_numpy(to_nchw(x)), ty)
    (got * torch.from_numpy(to_nchw(cot))).sum().backward()
    _finite(ty.grad)
    np.testing.assert_allclose(to_nhwc(got.detach().numpy()),
                               np.asarray(want), **VAL)
    np.testing.assert_allclose(to_nhwc(ty.grad.numpy()), np.asarray(jg),
                               **GRAD)
    if case == "random":
        sim_t = tssim.image_similarity(
            0.85, torch.from_numpy(to_nchw(x)), torch.from_numpy(to_nchw(y)))
        sim_j = jssim.image_similarity(0.85, jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(to_nhwc(sim_t.numpy()), np.asarray(sim_j),
                                   **VAL)

