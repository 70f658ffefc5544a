"""The port's bilinear samplers (K5), their coordinate gradient (K5b) and
their image gradient (K6) on the CPU, where the wrappers take the kernels'
plain versions, against the JAX Pallas kernels (``sndepth_tpu.kernels.warp``,
run by the Pallas interpreter on the CPU, with the Pallas splat forced) and
against the JAX split ops (``sndepth_tpu.ops.warp``), in both modes: values,
coordinate gradients and image gradients.

Tolerances: values atol 1e-5 (the JAX kernel's own tolerance against its
split ops, four-term float32 sums in another order). Coordinate gradients
atol 1e-4, as the JAX kernel's own tests. Image gradients: atol 1e-5 on
smooth in-image coordinates; atol 3e-4 on random coordinates up to 6 pixels
outside, where at edge-clamp sites the large, cancelling corner weights
leave ~1e-4 of float32 residue that depends on the order of the adds (the
JAX splat test's tolerance and reason); atol 2e-3 on coordinates up to 60
pixels outside, where those weights reach 60^2 = 3600 and one float32
rounding of a term is 2.4e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sndepth_tpu.kernels.warp as jkw
from sndepth_tpu.ops import warp as jwarp
from sndepth_tpu_torch.kernels import warp as K5
from sndepth_tpu_torch.ops import warp as twarp
from sndepth_tpu_torch.utils.layout import to_nchw, to_nhwc
from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield

MODES = ("edge_zero", "zero_pad")
JAX_SPLIT = {"edge_zero": jwarp.bilinear_sampler,
             "zero_pad": jwarp.bilinear_sampler_zero_pad}
# One function object a mode, so that the compiled JAX kernel is reused.
PALLAS = {mode: functools.partial(jkw.bilinear_sampler, mode=mode)
          for mode in ("edge_zero", "zero_pad")}
PORT = {"edge_zero": twarp.bilinear_sampler,
        "zero_pad": twarp.bilinear_sampler_zero_pad}
PORT_REF = {"edge_zero": twarp.bilinear_sampler_reference,
            "zero_pad": twarp.bilinear_sampler_zero_pad_reference}


def _case(kind, c):
    """(imgs NHWC, coords NHWC, cotangent NHWC, image-gradient atol)."""
    rng = np.random.RandomState({"random": 0, "smooth": 1, "far": 2,
                                 "outside": 3, "lookup": 4}[kind] + c)
    if kind == "smooth":
        b, h, w = 2, 16, 48
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        coords = np.stack([xs, ys], -1)[None].repeat(b, 0) + rng.uniform(
            -2, 2, (b, h, w, 2))
        ht, wt, atol = h, w, 1e-5
    elif kind == "outside":
        # Many channels and most samples wholly outside the image, as at
        # UniAD's spatial cross-attention levels.
        b, h, w, ht, wt, atol = 2, 7, 9, 5, 6, 1e-5
        coords = rng.uniform(-2 * w, 3 * w, (b, ht, wt, 2))
    elif kind == "lookup":
        # RAFT2D's correlation lookup: a 9x9 window of taps around a point
        # of each of many small planes, some windows partly outside.
        b, h, w, ht, wt, atol = 24, 4, 6, 9, 9, 1e-5
        d = np.arange(-4.0, 5.0)
        window = np.stack(np.meshgrid(d, d), -1)
        coords = (rng.uniform(-3, max(h, w) + 2, (b, 1, 1, 2))
                  + window[None])
    else:
        # The target plane has another size than the source plane.
        b, h, w, ht, wt = 2, 13, 37, 11, 29
        spread, atol = (6, 3e-4) if kind == "random" else (60, 2e-3)
        coords = rng.uniform(-spread, max(h, w) + spread, (b, ht, wt, 2))
    imgs = rng.rand(b, h, w, c).astype(np.float32)
    cot = (rng.rand(b, ht, wt, c) * 2 - 1).astype(np.float32)
    return imgs, coords.astype(np.float32), cot, atol


def _vjp(fn, imgs, coords, cot):
    out, vjp = jax.vjp(fn, imgs, coords)
    return (out,) + vjp(cot)


def _jax_all(fn, imgs, coords, cot):
    """Value and both gradients of the JAX function ``fn``, op by op: XLA's
    fusion would round the split ops' cancelling border weights otherwise
    than the port and the Pallas kernel do."""
    return tuple(np.asarray(a) for a in _vjp(
        fn, jnp.asarray(imgs), jnp.asarray(coords), jnp.asarray(cot)))


_pallas_vjp = jax.jit(_vjp, static_argnums=0)


def _pallas_all(mode, imgs, coords, cot):
    """As :func:`_jax_all` for the Pallas kernel (interpreted), compiled
    once a mode and shape: op by op it takes seconds a call."""
    return tuple(np.asarray(a) for a in _pallas_vjp(
        PALLAS[mode], jnp.asarray(imgs), jnp.asarray(coords),
        jnp.asarray(cot)))


def _port_all(fn, imgs, coords, cot):
    ti = torch.from_numpy(to_nchw(imgs)).requires_grad_(True)
    tc = torch.from_numpy(to_nchw(coords)).requires_grad_(True)
    out = fn(ti, tc)
    (out * torch.from_numpy(to_nchw(cot))).sum().backward()
    for t in (out, ti.grad, tc.grad):
        assert torch.isfinite(t).all()
    return (to_nhwc(out.detach().numpy()), to_nhwc(ti.grad.numpy()),
            to_nhwc(tc.grad.numpy()))


def _compare(got, want, img_atol):
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=img_atol)
    np.testing.assert_allclose(got[2], want[2], atol=1e-4)


@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("kind", ["random", "smooth", "far"])
@pytest.mark.parametrize("mode", MODES)
def test_sampler_matches_jax_pallas_kernel(mode, kind, c, monkeypatch):
    """Gather, tangent contraction and splat against the JAX kernels."""
    monkeypatch.setattr(jkw, "_SPLAT", "pallas")
    imgs, coords, cot, atol = _case(kind, c)
    want = _pallas_all(mode, imgs, coords, cot)
    _compare(_port_all(PORT[mode], imgs, coords, cot), want, atol)


@pytest.mark.parametrize("mode,kind,c", [
    (mode, kind, c) for mode in MODES
    for kind in ("random", "smooth", "far") for c in (2, 3)] + [
    # The shapes the gather and its coordinate gradient were redesigned
    # for: C = 32 with most samples wholly outside the image (whose taps
    # the zero_pad kernels do not read), C = 1 over many 9x9 targets.
    ("zero_pad", "outside", 32), ("zero_pad", "lookup", 1)])
def test_sampler_matches_jax_split_ops(mode, kind, c):
    imgs, coords, cot, atol = _case(kind, c)
    want = _jax_all(JAX_SPLIT[mode], imgs, coords, cot)
    got = _port_all(PORT[mode], imgs, coords, cot)
    _compare(got, want, atol)
    # The autograd-differentiated plain sampler agrees with the function
    # built on the kernel's plain versions (explicit tangents, index_add_).
    _compare(_port_all(PORT_REF[mode], imgs, coords, cot), want, atol)
    if kind == "outside":
        h, w = imgs.shape[1:3]
        x, y = coords[..., 0], coords[..., 1]
        out = (x < -1) | (x > w) | (y < -1) | (y > h)
        assert out.mean() > 0.5
        assert (got[0][out] == 0).all() and (got[2][out] == 0).all()


def _border_coords(h, w):
    """Integer coordinates on the last row and column, the first row and
    column, just inside and outside them, far out and negative."""
    xs = np.array([0.0, 0.5, w - 2.0, w - 1.5, w - 1.0, w - 0.5, float(w),
                   -0.5, -1.0, -7.25, w + 30.0], np.float32)
    ys = np.array([0.0, h - 2.0, h - 1.0, h - 0.25, float(h), -1.0, -0.75,
                   h + 12.0], np.float32)
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx, gy], -1)[None]


@pytest.mark.parametrize("mode", MODES)
def test_border_and_far_out_coordinates_match_jax(mode, monkeypatch):
    monkeypatch.setattr(jkw, "_SPLAT", "pallas")
    rng = np.random.RandomState(5)
    h, w = 7, 9
    imgs = (rng.rand(1, h, w, 3) + 0.5).astype(np.float32)
    coords = _border_coords(h, w)
    cot = np.ones(coords.shape[:3] + (3,), np.float32)
    got = _port_all(PORT[mode], imgs, coords, cot)
    _compare(got, _jax_all(JAX_SPLIT[mode], imgs, coords, cot), 1e-5)
    _compare(got, _pallas_all(mode, imgs, coords, cot), 1e-5)
    # The two modes differ exactly on the last row and column: edge_zero
    # zeroes them, zero_pad returns the border pixel with weight 1.
    last_col = got[0][0, 0, 4]          # (x, y) = (w - 1, 0)
    last_row = got[0][0, 2, 0]          # (x, y) = (0, h - 1)
    if mode == "edge_zero":
        assert (last_col == 0).all() and (last_row == 0).all()
    else:
        np.testing.assert_array_equal(last_col, imgs[0, 0, w - 1])
        np.testing.assert_array_equal(last_row, imgs[0, h - 1, 0])
    far = got[0][0, -1, -1]             # (w + 30, h + 12)
    assert (far == 0).all()


def test_tangents_differ_between_modes_outside_the_image():
    """One pixel left of the image: edge_zero keeps the derivative of its
    clamped weights, zero_pad only that of its one valid corner."""
    imgs = torch.arange(1.0, 13.0).reshape(1, 1, 3, 4)
    coords = torch.tensor([-0.5, 1.0]).reshape(1, 2, 1, 1)
    g = torch.ones(1, 1, 1, 1)
    out_e = K5.warp_gather(imgs, coords, "edge_zero")
    out_z = K5.warp_gather(imgs, coords, "zero_pad")
    dx_e, dy_e = K5.warp_coord_grad_reference(imgs, coords, g, "edge_zero")[0]
    dx_z, _ = K5.warp_coord_grad_reference(imgs, coords, g, "zero_pad")[0]
    # edge_zero: both corners clamp to column 0, weights 0.5 and -0.5.
    assert float(out_e) == 0.0 and float(dx_e) == 0.0 and float(dy_e) == 0.0
    # zero_pad: only column 0 is valid, weight 0.5, derivative +1.
    assert float(out_z) == 0.5 * 5.0 and float(dx_z) == 5.0


@pytest.mark.parametrize("mode", MODES)
def test_kernel_plain_versions_return_what_the_kernels_write(mode):
    """warp_gather, warp_coord_grad and warp_splat against autograd through
    the plain sampler."""
    imgs, coords, cot, atol = _case("random", 2)
    ti = torch.from_numpy(to_nchw(imgs))
    tc = torch.from_numpy(to_nchw(coords))
    tg = torch.from_numpy(to_nchw(cot))
    out = K5.warp_gather(ti, tc, mode)
    torch.testing.assert_close(out, K5.warp_gather_reference(ti, tc, mode),
                               rtol=0, atol=0)
    ti_, tc_ = ti.clone().requires_grad_(True), tc.clone().requires_grad_(True)
    ref = K5.sampler_reference(ti_, tc_, mode)
    d_i, d_c = torch.autograd.grad(ref, (ti_, tc_), tg)
    torch.testing.assert_close(out, ref.detach(), atol=1e-6, rtol=0)
    torch.testing.assert_close(K5.warp_coord_grad(ti, tc, tg, mode), d_c,
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(
        K5.warp_splat(tc, tg, imgs.shape[1], imgs.shape[2], mode), d_i,
        atol=atol, rtol=0)


def _far_coords(rng, b, ht, wt, h, w):
    """Coordinates up to 3 image sizes outside the image on every side."""
    lo, hi = -3.0 * max(h, w), 4.0 * max(h, w)
    return rng.uniform(lo, hi, (b, ht, wt, 2)).astype(np.float32)


@pytest.mark.parametrize("where", ["border", "far"])
@pytest.mark.parametrize("mode", MODES)
def test_coord_grad_plain_version_matches_autograd(mode, where):
    """The coordinate gradient's plain version (tangents contracted over the
    channels) against autograd through ``sampler_reference``, on the border
    cases and on random far-out coordinates. atol 1e-5 + rtol 1e-5: the
    same products summed in another grouping."""
    rng = np.random.RandomState(13)
    h, w, c = 7, 9, 3
    if where == "border":
        coords = _border_coords(h, w)
    else:
        coords = _far_coords(rng, 2, 5, 6, h, w)
    b = coords.shape[0]
    imgs = (rng.rand(b, h, w, c) + 0.5).astype(np.float32)
    cot = (rng.rand(b, *coords.shape[1:3], c) * 2 - 1).astype(np.float32)
    ti = torch.from_numpy(to_nchw(imgs))
    tc = torch.from_numpy(to_nchw(coords))
    tg = torch.from_numpy(to_nchw(cot))
    tc_ = tc.clone().requires_grad_(True)
    want, = torch.autograd.grad(K5.sampler_reference(ti, tc_, mode), tc_, tg)
    got = K5.warp_coord_grad_reference(ti, tc, tg, mode)
    assert got.shape == tc.shape and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_autograd_function_saves_no_tangent_planes():
    """The backward keeps the inputs, images and coordinates, and nothing
    the size of C sample planes."""
    imgs, coords, _, _ = _case("smooth", 3)
    ti = torch.from_numpy(to_nchw(imgs)).requires_grad_(True)
    tc = torch.from_numpy(to_nchw(coords)).requires_grad_(True)
    out = K5.bilinear_sample(ti, tc, "edge_zero")
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 2
    assert saved[0].data_ptr() == ti.data_ptr() and saved[0].shape == ti.shape
    assert saved[1].data_ptr() == tc.data_ptr() and saved[1].shape == tc.shape


@pytest.mark.parametrize("mode", MODES)
def test_nan_coordinate_gives_nan_gradient_at_that_pixel_only(mode):
    imgs, coords, cot, _ = _case("smooth", 2)
    coords = coords.copy()
    coords[1, 5, 7] = np.nan
    ti = torch.from_numpy(to_nchw(imgs))
    tc = torch.from_numpy(to_nchw(coords)).requires_grad_(True)
    out = K5.bilinear_sample(ti, tc, mode)
    (out * torch.from_numpy(to_nchw(cot))).sum().backward()
    bad = torch.zeros(tc.shape, dtype=torch.bool)
    bad[1, :, 5, 7] = True
    assert torch.isnan(tc.grad[bad]).all()
    assert torch.isfinite(tc.grad[~bad]).all()
    assert torch.isnan(out[1, :, 5, 7]).all()
    assert torch.isfinite(out.detach()[~bad[:, :1].expand_as(out)]).all()


def test_splat_shared_share_follows_the_tap_boxes():
    """Small flows keep every tile's tap box in the shared-memory budget;
    coordinates spread over the image put none there; the budget is in
    floats, so more channels fit fewer cells."""
    b, h, w = 1, 20, 70
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    grid = torch.from_numpy(np.stack([xs, ys])[None].repeat(b, 0))
    rng = np.random.RandomState(4)
    small = grid + torch.from_numpy(
        rng.uniform(-1.5, 1.5, grid.shape).astype(np.float32))
    assert K5.splat_shared_share(small, h, w, 2, "edge_zero") == 1.0
    spread = torch.from_numpy(_far_coords(rng, b, h, w, 60, 200)).permute(
        0, 3, 1, 2).contiguous()
    assert K5.splat_shared_share(spread, 60, 200, 1, "zero_pad") == 0.0
    # Coordinates stretched 3 times in x and 6 in y: a whole tile's box is
    # 97 x 49 cells, over the budget at any C; the ragged edge's smaller
    # boxes fit at C = 1 and not at C = 4.
    tiles = grid.clone()
    tiles[:, 0] = tiles[:, 0] * 3.0
    tiles[:, 1] = tiles[:, 1] * 6.0
    share_1 = K5.splat_shared_share(tiles, 200, 300, 1, "edge_zero")
    share_4 = K5.splat_shared_share(tiles, 200, 300, 4, "edge_zero")
    assert share_4 < share_1


def test_images_get_no_splat_when_they_want_no_gradient(monkeypatch):
    imgs, coords, cot, _ = _case("smooth", 3)
    calls = []
    monkeypatch.setattr(K5, "warp_splat",
                        lambda *a, **k: calls.append(a) or None)
    ti = torch.from_numpy(to_nchw(imgs))
    tc = torch.from_numpy(to_nchw(coords)).requires_grad_(True)
    twarp.bilinear_sampler(ti, tc).sum().backward()
    assert calls == [] and torch.isfinite(tc.grad).all()


def test_flow_warp_of_a_flow_matches_jax():
    """A flow warped by a flow, differentiated in both, as the stage-2
    consistency masks use it."""
    rng = np.random.RandomState(9)
    flow = rng.uniform(-3, 3, (1, 16, 40, 2)).astype(np.float32)
    other = rng.uniform(-3, 3, (1, 16, 40, 2)).astype(np.float32)
    cot = (rng.rand(1, 16, 40, 2) * 2 - 1).astype(np.float32)
    want = _jax_all(jwarp.flow_warp, other, flow, cot)
    _compare(_port_all(twarp.flow_warp, other, flow, cot), want, 1e-5)
    _compare(_port_all(twarp.flow_warp_reference, other, flow, cot), want,
             1e-5)


@pytest.mark.parametrize("bad", ["dtype", "layout", "mode", "coords", "batch"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    imgs = torch.zeros(2, 3, 6, 8)
    coords = torch.zeros(2, 2, 6, 8)
    mode = "edge_zero"
    if bad == "dtype":
        imgs = imgs.double()
    elif bad == "layout":
        coords = coords.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif bad == "mode":
        mode = "reflect"
    elif bad == "coords":
        coords = torch.zeros(2, 3, 6, 8)
    else:
        coords = torch.zeros(1, 2, 6, 8)
    with pytest.raises((TypeError, ValueError)):
        K5.warp_gather(imgs, coords, mode)


@pytest.mark.parametrize("b,npix,want", [
    (1, 1, 1),                        # the smallest call
    (7332, 81, 1),                    # RAFT2D-Large's lookup at 376x1248
    (70000, 81, 1),                   # its folded batch
    (64, 128 * 416, 1),               # GeoNet stage 2
    (2, 2**30 - 1, 1),                # 2^31 - 2 pixels: still one
    (3, 2**30 - 1, 2),                # past 2^31: a launch a batch of two
    (2, 2**30, 2),                    # 2^31 pixels: two
    (5, 2**31 - 1, 5),                # a plane a launch
])
def test_sampler_launches_count_batches_below_2_31_pixels(b, npix, want):
    """The counter adds what ``warp.cu``'s launcher makes: one launch for
    each batch of planes of fewer than 2^31 target pixels."""
    assert K5.sampler_launches(b, npix) == want
