"""The plain tensor operations around RAFT3D against the JAX package on the
same inputs, made from a seed with numpy: ``ops/projective.py``,
``ops/resize.py``, ``ops/patches.py``, and from ``models/raft3d.py`` and
``models/grid_smoother.py`` the convex upsampling, the SE3 upsampling, the
unrolled 6x6 Cholesky solve and the grid solve.

Layouts: these functions are channel-last on both sides except
``grid_sampler``'s image and ``resize_bilinear_align_corners``, which are
NCHW in the port and go through ``utils/layout.py``.

Tolerances: atol 1e-5 + rtol 1e-5 for closed forms in float32 (projection
divides by depths near 1); 2e-5 for the 16-iteration conjugate gradient,
whose reductions sum in another order (2e-3 where it has not converged); 1e-4 relative for the Cholesky
solve of a well-conditioned system. Every output and gradient is asserted
finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sndepth_tpu.models import grid_smoother as jgrid
from sndepth_tpu.models import raft3d as jraft
from sndepth_tpu.ops import patches as jpatches
from sndepth_tpu.ops import projective as jproj
from sndepth_tpu.ops import resize as jresize
from sndepth_tpu.ops import se3 as jse3
from sndepth_tpu_torch.models import grid_smoother as tgrid
from sndepth_tpu_torch.models import raft3d as traft
from sndepth_tpu_torch.ops import patches as tpatches
from sndepth_tpu_torch.ops import projective as tproj
from sndepth_tpu_torch.ops import resize as tresize
from sndepth_tpu_torch.utils.layout import to_nchw, to_nhwc
from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _scene(seed=0, b=2, h=7, w=9):
    rng = np.random.RandomState(seed)
    depth = (1.0 + rng.rand(b, h, w)).astype(np.float32)
    intr = np.array([[20.0, 21.0, 4.0, 3.0], [18.0, 19.0, 4.5, 3.5]],
                    np.float32)[:b]
    tangent = (rng.randn(b, h, w, 6) * 0.05).astype(np.float32)
    Ts = np.array(jse3.exp(jnp.asarray(tangent)))
    return depth, intr, Ts, rng


def test_project_and_inv_project_match_jax():
    depth, intr, _, rng = _scene()
    pts = tproj.inv_project(_t(depth), _t(intr))
    _check(pts, jproj.inv_project(jnp.asarray(depth), jnp.asarray(intr)))
    _check(tproj.project(pts, _t(intr)),
           jproj.project(jnp.asarray(pts.numpy()), jnp.asarray(intr)))


@pytest.mark.parametrize("fn", ["projective_transform", "induced_flow"])
def test_transform_and_induced_flow_match_jax(fn):
    depth, intr, Ts, _ = _scene(1)
    depth[0, 0, 0] = 0.01                  # below MIN_DEPTH: invalid
    got = getattr(tproj, fn)(_t(Ts), _t(depth), _t(intr))
    want = getattr(jproj, fn)(*map(jnp.asarray, (Ts, depth, intr)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # The pixel below MIN_DEPTH projects through 1 / 0.01.
        _check(g, w, atol=1e-4, rtol=1e-5)
    assert got[-1][0, 0, 0] == 0 and got[-1].sum() == depth.size - 1


def test_backproject_flow3d_matches_jax():
    rng = np.random.RandomState(2)
    flow = rng.randn(6, 8, 2).astype(np.float32)
    d0, d1 = ((1 + rng.rand(6, 8)).astype(np.float32) for _ in range(2))
    k = np.array([20.0, 21.0, 4.0, 3.0], np.float32)
    _check(tproj.backproject_flow3d(_t(flow), _t(d0), _t(d1), _t(k)),
           jproj.backproject_flow3d(*map(jnp.asarray, (flow, d0, d1, k))))


def test_grid_and_depth_sampler_match_jax_with_out_of_image_coords():
    rng = np.random.RandomState(3)
    b, h, w = 2, 6, 8
    img = rng.randn(b, h, w, 3).astype(np.float32)
    depth = (1 + rng.rand(b, h, w)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(5), np.arange(7), indexing="ij")
    coords = (np.stack([xs, ys], -1)[None] + rng.randn(b, 5, 7, 2) * 3
              ).astype(np.float32)
    coords[0, 0, 0] = [w - 1.0, h - 1.0]       # exactly on the last pixel
    coords[0, 0, 1] = [-7.0, 30.0]             # far outside
    got, valid = tproj.grid_sampler(_t(to_nchw(img)), _t(coords))
    want, jvalid = jproj.grid_sampler(jnp.asarray(img), jnp.asarray(coords))
    _check(to_nhwc(got.numpy()), want)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert 0 < valid.sum() < valid.numel() and valid[0, 0, 0] == 1
    got, valid = tproj.depth_sampler(_t(depth), _t(coords))
    want, jvalid = jproj.depth_sampler(jnp.asarray(depth),
                                       jnp.asarray(coords))
    _check(got, want)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert got[0, 0, 1] == 0


@pytest.mark.parametrize("size", [((4, 13), (16, 52)), ((5, 7), (5, 7)),
                                  ((6, 9), (3, 4)), ((1, 5), (4, 10))])
def test_resize_bilinear_align_corners_matches_jax(size):
    (h, w), (oh, ow) = size
    x = np.random.RandomState(4).randn(2, h, w, 3).astype(np.float32)
    got = tresize.resize_bilinear_align_corners(_t(to_nchw(x)), oh, ow)
    want = jresize.resize_bilinear_align_corners(jnp.asarray(x), oh, ow)
    _check(to_nhwc(got.numpy()), want)


@pytest.mark.parametrize("k,dilation", [(3, 1), (3, 2), (5, 1), (9, 4)])
def test_extract_patches_matches_jax_tap_for_tap(k, dilation):
    x = np.random.RandomState(5).randn(2, 6, 7, 3).astype(np.float32)
    got = tpatches.extract_patches(_t(x), k, dilation)
    want = jpatches.extract_patches(jnp.asarray(x), k, dilation)
    assert got.shape == (2, 6, 7, k * k, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cvx_upsample_matches_jax_and_honours_the_mask_layout():
    rng = np.random.RandomState(6)
    data = rng.randn(2, 4, 5, 3).astype(np.float32)
    mask = rng.randn(2, 4, 5, 9 * 64).astype(np.float32)
    _check(traft.cvx_upsample(_t(data), _t(mask)),
           jraft.cvx_upsample(jnp.asarray(data), jnp.asarray(mask)))
    # Channel tap * 64 + u * 8 + v: a mask that puts all weight on tap 4
    # (the centre) copies each coarse value to its 8 x 8 block; on tap 5,
    # the right neighbour's (zero past the border).
    for tap, shift in ((4, 0), (5, 1)):
        hard = np.full((2, 4, 5, 9, 8, 8), -1e4, np.float32)
        hard[:, :, :, tap] = 1e4
        up = traft.cvx_upsample(_t(data), _t(hard.reshape(2, 4, 5, -1)))
        want = np.zeros_like(data)
        want[:, :, :5 - shift] = data[:, :, shift:]
        np.testing.assert_allclose(
            up.numpy(), np.repeat(np.repeat(want, 8, 1), 8, 2), atol=1e-6)


def test_upsample_se3_matches_jax_values_and_gradients():
    _, _, Ts, rng = _scene(7, b=1, h=3, w=4)
    mask = rng.randn(1, 3, 4, 9 * 64).astype(np.float32)
    cot = rng.randn(1, 24, 32, 7).astype(np.float32)
    t, m = _t(Ts).requires_grad_(True), _t(mask).requires_grad_(True)
    out = traft.upsample_se3(t, m)
    (out * _t(cot)).sum().backward()
    want, vjp = jax.vjp(jraft.upsample_se3, jnp.asarray(Ts),
                        jnp.asarray(mask))
    _check(out, want)
    for got, w in zip((t.grad, m.grad), vjp(jnp.asarray(cot))):
        _check(got, w, atol=1e-5, rtol=1e-4)


def _spd(seed, shape=(3, 11)):
    rng = np.random.RandomState(seed)
    a = rng.randn(*shape, 6, 9).astype(np.float32)
    H = a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(6, dtype=np.float32)
    return H, rng.randn(*shape, 6).astype(np.float32)


def test_cholesky_solve6_matches_jax_and_solves_the_system():
    H, g = _spd(8)
    got = traft.cholesky_solve6(_t(H), _t(g))
    _check(got, jraft.cholesky_solve6(jnp.asarray(H), jnp.asarray(g)),
           atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(
        np.einsum("...ij,...j->...i", H, got.numpy()), g, atol=1e-4,
        rtol=1e-4)


def test_cholesky_solve6_floors_the_pivots_of_a_singular_system():
    """A zero matrix has pivots max(0, 1e-12) under the root: the result is
    finite and equal to JAX's."""
    H = np.zeros((2, 6, 6), np.float32)
    g = np.random.RandomState(9).randn(2, 6).astype(np.float32)
    _check(traft.cholesky_solve6(_t(H), _t(g)),
           jraft.cholesky_solve6(jnp.asarray(H), jnp.asarray(g)),
           atol=0, rtol=1e-5)


def test_cholesky_solve6_gradients_match_jax():
    H, g = _spd(10, shape=(4,))
    cot = np.random.RandomState(11).randn(4, 6).astype(np.float32)
    th, tg = _t(H).requires_grad_(True), _t(g).requires_grad_(True)
    (traft.cholesky_solve6(th, tg) * _t(cot)).sum().backward()
    want = jax.grad(lambda a, b: jnp.sum(jraft.cholesky_solve6(a, b) * cot),
                    argnums=(0, 1))(jnp.asarray(H), jnp.asarray(g))
    for got, w in zip((th.grad, tg.grad), want):
        _check(got, w, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("shape,scale,tol", [
    ((2, 6, 7, 16), 1.0, 2e-5), ((1, 5, 5, 3), 5.0, 2e-5),
    ((2, 6, 7, 16), 5.0, 2e-3)])
def test_grid_solve_matches_jax(shape, scale, tol):
    """Edge weights of 5 * |N(0, 1)| (the update block's are 5 * softplus)
    on a 6 x 7 grid leave 16 conjugate-gradient iterations short of
    convergence and sensitive to the order of the float32 reductions: the
    JAX result lies 5e-4 and the port's 2e-4 from a float64 evaluation of
    the port, so that case is held to 2e-3 and to that float64 evaluation."""
    rng = np.random.RandomState(12)
    ae = rng.randn(*shape).astype(np.float32)
    wx, wy = (np.abs(rng.randn(*shape[:3], 1)).astype(np.float32) * scale
              for _ in range(2))
    got = tgrid.grid_solve(_t(ae), _t(wx), _t(wy))
    want = jgrid.grid_solve(*map(jnp.asarray, (ae, wx, wy)))
    _check(got, want, atol=tol, rtol=tol)
    exact = tgrid.grid_solve(_t(ae).double(), _t(wx).double(),
                             _t(wy).double())
    _check(got, exact.numpy(), atol=tol, rtol=tol)
    smoother = tgrid.GridSmoother()
    _check(smoother(_t(ae), _t(np.concatenate([wx, wy], -1))), want,
           atol=tol, rtol=tol)


def test_grid_solve_solves_its_system_and_differentiates():
    rng = np.random.RandomState(13)
    ae = _t(rng.randn(1, 5, 6, 2).astype(np.float32)).requires_grad_(True)
    wx = _t(np.abs(rng.randn(1, 5, 6, 1)).astype(np.float32)
            ).requires_grad_(True)
    wy = _t(np.abs(rng.randn(1, 5, 6, 1)).astype(np.float32))
    x = tgrid.grid_solve(ae, wx, wy, iters=40)
    residual = (x + tgrid._dxT(wx[:, :, :-1] * tgrid._dx(x))
                + tgrid._dyT(wy[:, :-1] * tgrid._dy(x)) - ae)
    assert float(residual.detach().abs().max()) < 1e-4
    x.square().sum().backward()
    assert torch.isfinite(ae.grad).all() and torch.isfinite(wx.grad).all()
    assert float(wx.grad.abs().max()) > 0
