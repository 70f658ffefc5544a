"""The port's smoothness sums (K2) on the CPU, where they take their plain
version, against the JAX kernel ``smooth_loss_sums`` (Pallas interpreter on
the CPU) and the JAX split ``smooth_loss``, on sums and depth gradients.

Tolerances: sums rtol 1e-5 (float32 sums of ~10^3 terms in different
orders); depth gradients atol 1e-6 + rtol 1e-5: each entry is at most two
products sign * exp(-mean |grad|), computed in float32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sndepth_tpu.kernels.smooth_loss import smooth_loss_sums as jax_sums
from sndepth_tpu.losses.photometric import smooth_loss as jax_smooth
from sndepth_tpu_torch.kernels import smooth_loss as K2
from sndepth_tpu_torch.losses.photometric import smooth_loss
from sndepth_tpu_torch.utils.layout import to_nchw, to_nhwc
from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield

GRAD_TOL = dict(atol=1e-6, rtol=1e-5)


def _case(seed, n=3, h=16, w=40):
    rng = np.random.RandomState(seed)
    depth = (rng.rand(n, h, w, 1) * 5 + 0.1).astype(np.float32)
    image = (rng.rand(n, h, w, 3) * 2 - 1).astype(np.float32)
    return depth, image


def _port_sums(depth, image):
    d = torch.from_numpy(to_nchw(depth)).requires_grad_(True)
    sx, sy = K2.smooth_loss_sums(d, torch.from_numpy(to_nchw(image)))
    (0.3 * sx + 0.7 * sy).backward()
    g = to_nhwc(d.grad.numpy())
    assert np.isfinite(g).all()
    return float(sx.detach()), float(sy.detach()), g


@pytest.mark.parametrize("shape", [(3, 16, 40), (2, 8, 130)])
def test_sums_and_depth_grad_match_jax_kernel(shape):
    n, h, w = shape
    depth, image = _case(0, n, h, w)
    (jx, jy), vjp = jax.vjp(lambda d: jax_sums(d, jnp.asarray(image)),
                            jnp.asarray(depth))
    (jg,) = vjp((jnp.float32(0.3), jnp.float32(0.7)))
    sx, sy, g = _port_sums(depth, image)
    np.testing.assert_allclose([sx, sy], [float(jx), float(jy)], rtol=1e-5)
    np.testing.assert_allclose(g, np.asarray(jg), **GRAD_TOL)


def test_smooth_loss_matches_jax_split_loss():
    depth, image = _case(1)
    want, jg = jax.value_and_grad(
        lambda d: jax_smooth(d, jnp.asarray(image)))(jnp.asarray(depth))
    d = torch.from_numpy(to_nchw(depth)).requires_grad_(True)
    got = smooth_loss(d, torch.from_numpy(to_nchw(image)))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    g = to_nhwc(d.grad.numpy())
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, np.asarray(jg), atol=1e-8, rtol=1e-5)


def test_plain_version_matches_autograd_of_the_definition():
    depth, image = (torch.from_numpy(to_nchw(a)) for a in _case(2))
    d = depth.clone().requires_grad_(True)
    wx = torch.exp(-(image[..., :-1] - image[..., 1:]).abs().mean(1, True))
    wy = torch.exp(-(image[..., :-1, :] - image[..., 1:, :]).abs().mean(
        1, True))
    sx = ((d[..., :-1] - d[..., 1:]).abs() * wx).sum()
    sy = ((d[..., :-1, :] - d[..., 1:, :]).abs() * wy).sum()
    gx, = torch.autograd.grad(sx, d, retain_graph=True)
    gy, = torch.autograd.grad(sy, d)
    rx, ry, ddx, ddy = K2.smooth_sums_reference(depth, image)
    torch.testing.assert_close(torch.stack([rx, ry]),
                               torch.stack([sx, sy]).detach())
    torch.testing.assert_close(ddx, gx)
    torch.testing.assert_close(ddy, gy)


def test_image_gets_no_gradient():
    depth, image = (torch.from_numpy(to_nchw(a)) for a in _case(3))
    image.requires_grad_(True)
    depth.requires_grad_(True)
    sum(K2.smooth_loss_sums(depth, image)).backward()
    assert image.grad is None and depth.grad is not None


@pytest.mark.parametrize("bad", ["dtype", "layout", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    depth, image = (torch.from_numpy(to_nchw(a)) for a in _case(4))
    if bad == "dtype":
        depth = depth.half()
    elif bad == "layout":
        image = image.transpose(-1, -2).contiguous().transpose(-1, -2)
    else:
        depth = depth[:, :, :-1].contiguous()
    with pytest.raises((TypeError, ValueError)):
        K2.smooth_sums(depth, image)
