"""The port's smoothness sums (K2) on the CPU, where they take their plain
version, against the JAX kernel ``smooth_loss_sums`` (Pallas interpreter on
the CPU), the JAX split ``smooth_loss`` and the JAX ``flow_smooth_loss``
(two planes a sample under one image), on sums and depth gradients.

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
from sndepth_tpu.losses.photometric import flow_smooth_loss as jax_flow_smooth
from sndepth_tpu.losses.photometric import smooth_loss as jax_smooth
from sndepth_tpu_torch.kernels import smooth_loss as K2
from sndepth_tpu_torch.losses.photometric import flow_smooth_loss, smooth_loss
from sndepth_tpu_torch.utils.layout import to_nchw, to_nhwc
from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield

GRAD_TOL = dict(atol=1e-6, rtol=1e-5)


def _case(seed, n=3, h=16, w=40, d=1):
    rng = np.random.RandomState(seed)
    depth = (rng.rand(n, h, w, d) * 5 + 0.1).astype(np.float32)
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


@pytest.mark.parametrize("bad", ["dtype", "layout", "shape", "three_planes",
                                 "planes_off_the_image"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    depth, image = (torch.from_numpy(to_nchw(a)) for a in _case(4))
    if bad == "dtype":
        depth = depth.half()
    elif bad == "layout":
        image = image.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif bad == "shape":
        depth = depth[:, :, :-1].contiguous()
    elif bad == "three_planes":
        depth = depth.expand(-1, 3, -1, -1).contiguous()
    else:
        # Two planes a sample, but of another width than the image.
        depth = depth.expand(-1, 2, -1, -1)[..., 1:].contiguous()
    with pytest.raises((TypeError, ValueError)):
        K2.smooth_sums(depth, image)


@pytest.mark.parametrize("shape", [(3, 16, 40), (2, 9, 37), (2, 8, 130),
                                   (1, 33, 97)])
def test_flow_smooth_loss_matches_jax(shape):
    """Two planes a sample (a flow) through the kernel's sums: the mean of
    the two channels' losses and its flow gradient, against the JAX
    ``flow_smooth_loss`` (two single-channel losses under one image)."""
    n, h, w = shape
    flow, image = _case(6, n, h, w, d=2)
    want, jg = jax.value_and_grad(
        lambda f: jax_flow_smooth(f, jnp.asarray(image)))(jnp.asarray(flow))
    f = torch.from_numpy(to_nchw(flow)).requires_grad_(True)
    got = flow_smooth_loss(f, torch.from_numpy(to_nchw(image)))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    g = to_nhwc(f.grad.numpy())
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, np.asarray(jg), atol=1e-8, rtol=1e-5)


def test_two_plane_plain_version_matches_two_single_plane_calls():
    flow, image = (torch.from_numpy(to_nchw(a))
                   for a in _case(7, 2, 9, 37, d=2))
    sx, sy, ddx, ddy = K2.smooth_sums_reference(flow, image)
    one = [K2.smooth_sums_reference(flow[:, k:k + 1].contiguous(), image)
           for k in range(2)]
    torch.testing.assert_close(torch.stack([sx, sy]), torch.stack(
        [one[0][0] + one[1][0], one[0][1] + one[1][1]]))
    torch.testing.assert_close(ddx, torch.cat([one[0][2], one[1][2]], 1),
                               rtol=0, atol=0)
    torch.testing.assert_close(ddy, torch.cat([one[0][3], one[1][3]], 1),
                               rtol=0, atol=0)


def test_flow_smooth_loss_calls_the_kernel_once_a_flow(monkeypatch):
    """Both channels of a flow go to the kernel in one call, whole: no
    channel slices, no second call."""
    seen = []
    wrapped = K2.smooth_sums

    def counting(depth, image):
        seen.append(tuple(depth.shape))
        return wrapped(depth, image)

    monkeypatch.setattr(K2, "smooth_sums", counting)
    flow, image = (torch.from_numpy(to_nchw(a))
                   for a in _case(8, 2, 9, 37, d=2))
    flow.requires_grad_(True)
    flow_smooth_loss(flow, image).backward()
    assert seen == [(2, 2, 9, 37)]
    assert flow.grad is not None and flow.grad.shape == flow.shape
