"""The port's RAFT2D and RAFT2DLarge against ``sndepth_tpu.models.raft2d``
on the CPU, on the same inputs and weights, made from a seed with numpy:
the all-pairs pyramid and its windowed lookup (window order, coordinates
outside the plane, odd pyramid sizes), both nets at 64x64 with 2
iterations, the weight round trips and the torchvision checkpoint reader.

``RAFT2DLarge``'s weights start in the port (its torchvision names) and
reach JAX through the JAX package's own ``convert_raft2d_large``; the native
``RAFT2D``'s start as JAX parameters from ``jax.eval_shape`` and numpy and
reach the port through ``raft2d_state_dict_from_jax``, once per module. In
both, the flow head's last kernel is scaled down (to 1e-3), as
``tests/test_convert_raft2d.py`` scales it, so that each iteration moves
the flow by a fraction of a pixel: the lookup is piecewise linear, and
O(10) pixel steps would carry float32 noise from one linear piece to
another.

JAX's sampler takes its XLA gather on this call (the window is 9 wide, under
its Pallas kernel's 32), and the port's takes its plain version on a CPU
tensor: the gather kernel runs only on the card (``chip_smoke.py``).

Tolerances: the pyramid atol 1e-5 + rtol 1e-5 (a 16-term float32 dot
product and 2x2 means in another order); the lookup on the same pyramid atol
1e-6 (the bilinear blend of four taps, weights rounded alike); both nets'
flows atol 2e-4 + rtol 2e-4, as the JAX test holds JAX against its torch
replica (measured 3.2e-5 on RAFT2DLarge's upsampled flow, whose mean
magnitude is ~1 pixel; 1.4e-6 on the native RAFT2D's, whose mean magnitude
is 0.42 pixel, 0.063 at 1/8 scale). Each net's test also asks that flow to
be at least 100 times the atol, so that the comparison is not one of two
fields under the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sndepth_tpu.models import raft2d as jraft2d
from sndepth_tpu.utils.convert_weights import (convert_raft2d_checkpoint,
                                               convert_raft2d_large)
from sndepth_tpu_torch.models import raft2d as traft2d
from sndepth_tpu_torch.utils.layout import to_nchw, to_nhwc
from sndepth_tpu_torch.utils.threads import torch_threads
from sndepth_tpu_torch.utils.weights import (raft2d_large_checkpoint,
                                             raft2d_large_state_dict_from_jax,
                                             raft2d_state_dict_from_jax)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


H = W = 64
ITERS = 2
FLOW = dict(atol=2e-4, rtol=2e-4)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _check(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, **tol)


def _images(seed, b=1):
    rng = np.random.RandomState(seed)
    return tuple(rng.rand(b, H, W, 3).astype(np.float32) for _ in range(2))


# ----------------------------------------------------------------------
# Pyramid and lookup
# ----------------------------------------------------------------------

def _pyramid_case(seed, h, w, c=16, b=2, levels=4):
    rng = np.random.RandomState(seed)
    f1, f2 = (rng.randn(b, h, w, c).astype(np.float32) for _ in range(2))
    jp = jraft2d.tv_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), levels)
    tp = traft2d.tv_corr_pyramid(_t(to_nchw(f1)), _t(to_nchw(f2)), levels)
    return jp, tp


@pytest.mark.parametrize("hw,levels", [((8, 8), 4), ((11, 13), 3),
                                       ((16, 12), 4), ((7, 9), 2)])
def test_corr_pyramid_matches_jax_and_truncates_odd_sizes(hw, levels):
    h, w = hw
    jp, tp = _pyramid_case(1, h, w, levels=levels)
    assert len(tp) == len(jp) == levels
    for j, t in zip(jp, tp):
        assert t.shape == (2 * h * w, 1) + tuple(j.shape[1:3])
        _check(to_nhwc(t.numpy()), j, atol=1e-5, rtol=1e-5)
    if hw == (11, 13):
        assert [tuple(t.shape[2:]) for t in tp] == [(11, 13), (5, 6), (2, 3)]


def _query_coords(seed, b, h, w):
    """Level-0 coordinates around each query pixel, some far outside the
    plane on every side, some on its last row and column, a few exactly
    integer."""
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = (np.stack([xs, ys], -1)[None]
              + 3 * rng.randn(b, h, w, 2)).astype(np.float32)
    coords[0, 0, :5] = [[-30.0, 2.0], [2.0, -30.0], [w + 25.0, 1.0],
                        [1.0, h + 25.0], [w - 1.0, h - 1.0]]
    coords[-1, -1, -3:] = [[0.0, 0.0], [-4.5, 3.25], [w + 4.0, h + 4.0]]
    return coords


@pytest.mark.parametrize("hw,levels", [((8, 8), 4), ((11, 13), 3),
                                       ((7, 9), 2)])
def test_corr_lookup_matches_jax(hw, levels):
    """The lookup on JAX's own pyramid, handed across, and on the port's."""
    h, w = hw
    jp, tp = _pyramid_case(2, h, w, levels=levels)
    coords = _query_coords(3, 2, h, w)
    want = jraft2d.tv_corr_lookup(jp, jnp.asarray(coords), 4)
    handed = [_t(to_nchw(np.asarray(j))) for j in jp]
    got = traft2d.tv_corr_lookup(handed, _t(coords), 4)
    assert got.shape == (2, levels * 81, h, w)
    _check(to_nhwc(got.numpy()), want, atol=1e-6, rtol=0)
    _check(to_nhwc(traft2d.tv_corr_lookup(tp, _t(coords), 4).numpy()), want,
           atol=1e-5, rtol=1e-5)


def test_corr_lookup_window_is_dx_major_and_halves_level_by_level():
    """On planes whose value is the column index plus 100 times the row,
    channel i * 9 + j of level l samples (x / 2^l + d_i, y / 2^l + d_j),
    and a tap outside the plane reads 0."""
    h, w = 16, 16
    rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    plane = (cols + 100.0 * rows).astype(np.float32)
    pyramid = [torch.from_numpy(plane)[None, None]]
    for _ in range(3):
        pyramid.append(torch.nn.functional.avg_pool2d(pyramid[-1], 2, 2))
    coords = torch.tensor([[[[6.5, 5.25]]]])              # (1, 1, 1, 2)
    got = traft2d.tv_corr_lookup(pyramid, coords, 4)[0, :, 0, 0].numpy()
    d = np.arange(-4, 5, dtype=np.float32)
    for lvl in range(4):
        x, y = 6.5 / 2 ** lvl, 5.25 / 2 ** lvl
        pl = pyramid[lvl][0, 0].numpy()
        hl, wl = pl.shape
        for i in range(9):
            for j in range(9):
                xs, ys = x + d[i], y + d[j]
                value = got[lvl * 81 + i * 9 + j]
                if 0 <= xs <= wl - 1 and 0 <= ys <= hl - 1:
                    # A level-l plane holds (2^l x + c) + 100 (2^l y + c).
                    c = (2 ** lvl - 1) / 2
                    want = (2 ** lvl * xs + c) + 100 * (2 ** lvl * ys + c)
                    assert abs(value - want) < 1e-3, (lvl, i, j)
                elif xs <= -1 or xs >= wl or ys <= -1 or ys >= hl:
                    assert value == 0.0, (lvl, i, j)


def test_lookup_goes_through_the_gather_once_a_level(monkeypatch):
    """Each level of each iteration is one sampler call over the B H W
    query planes with a 9x9 target: 4 levels x 2 iterations here, 48 at
    the default 12 iterations."""
    calls = []
    real = traft2d.bilinear_sampler_zero_pad

    def spy(imgs, coords):
        calls.append((tuple(imgs.shape), tuple(coords.shape)))
        return real(imgs, coords)

    monkeypatch.setattr(traft2d, "bilinear_sampler_zero_pad", spy)
    model = traft2d.RAFT2DLarge().eval()
    im1, im2 = _images(4)
    with torch.no_grad():
        model(_t(to_nchw(im1)), _t(to_nchw(im2)), iters=ITERS)
    n = (H // 8) * (W // 8)
    assert len(calls) == 4 * ITERS
    assert [c[0] for c in calls[:4]] == [(n, 1, 8 >> l, 8 >> l)
                                         for l in range(4)]
    assert all(c[1] == (n, 2, 9, 9) for c in calls)


# ----------------------------------------------------------------------
# RAFT2DLarge
# ----------------------------------------------------------------------

def _randomize(model, seed=0):
    """Random weights and running statistics of the magnitudes
    ``tests/test_convert_raft2d.py`` uses, the flow head's last kernel
    small."""
    g = torch.Generator().manual_seed(seed)
    sd = model.state_dict()
    for k, v in sd.items():
        if not v.dtype.is_floating_point:
            continue
        if "running_var" in k:
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif "running_mean" in k:
            sd[k] = 0.2 * torch.randn(v.shape, generator=g)
        elif "flow_head.conv2" in k:
            sd[k] = 0.001 * torch.randn(v.shape, generator=g)
        else:
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
    model.load_state_dict(sd)
    return model


@pytest.fixture(scope="module")
def large():
    """(the port's RAFT2DLarge with random weights, the same weights as
    JAX variables through ``convert_raft2d_large``)."""
    model = _randomize(traft2d.RAFT2DLarge()).eval()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = jax.tree_util.tree_map(jnp.asarray, convert_raft2d_large(sd))
    return model, variables


@pytest.fixture(scope="module")
def jax_large_apply():
    net = jraft2d.RAFT2DLarge()
    return jax.jit(lambda v, a, b: net.apply(v, a, b, iters=ITERS,
                                             train_mode=True))


def test_raft2d_large_matches_jax(large, jax_large_apply):
    model, variables = large
    im1, im2 = (2 * x - 1 for x in _images(5))
    want_lo, want_up = jax_large_apply(variables, jnp.asarray(im1),
                                       jnp.asarray(im2))
    with torch.no_grad():
        lo, up = model(_t(to_nchw(im1)), _t(to_nchw(im2)), iters=ITERS,
                       train_mode=True)
        up_only = model(_t(to_nchw(im1)), _t(to_nchw(im2)), iters=ITERS)
    assert up.shape == (1, H, W, 2) and lo.shape == (1, H // 8, W // 8, 2)
    _check(lo, want_lo, **FLOW)
    _check(up, want_up, **FLOW)
    assert torch.equal(up_only, up)
    # The flow moved: the comparison is not of two zero fields.
    assert float(up.abs().mean()) > 100 * FLOW["atol"]


def test_raft2d_large_state_dict_has_torchvision_names(large):
    model, _ = large
    keys = set(model.state_dict())
    for key in ("feature_encoder.convnormrelu.0.weight",
                "feature_encoder.layer2.0.downsample.0.weight",
                "feature_encoder.conv.bias",
                "context_encoder.layer3.1.convnormrelu2.1.running_var",
                "context_encoder.layer2.0.downsample.1.weight",
                "update_block.motion_encoder.convcorr1.0.weight",
                "update_block.motion_encoder.conv.0.bias",
                "update_block.recurrent_block.convgru1.convz.weight",
                "update_block.recurrent_block.convgru2.convq.bias",
                "update_block.flow_head.conv2.weight",
                "mask_predictor.convrelu.0.bias", "mask_predictor.conv.weight"):
        assert key in keys, key
    for key in ("feature_encoder.convnormrelu.0.bias",
                "context_encoder.layer1.0.convnormrelu1.0.bias",
                "feature_encoder.layer1.0.downsample.0.weight"):
        assert key not in keys, key
    assert model.update_block.recurrent_block.convgru1.convz.kernel_size == (1, 5)


def test_raft2d_large_weights_round_trip_exactly(large):
    model, variables = large
    back = raft2d_large_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables))
    sd = model.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype, k
        assert torch.equal(back[k], v), k


def test_torchvision_checkpoint_loads_as_jax_converts_it(large, tmp_path):
    """A torchvision-style file: the state_dict under ``"model"``, with
    ``module.`` prefixes and the biases of the normalised convolutions.
    The port's reader loads it strictly and drops exactly those biases;
    its weights then convert to what ``convert_raft2d_checkpoint`` makes of
    the same file, bit for bit."""
    model, _ = large
    g = torch.Generator().manual_seed(7)
    sd = dict(model.state_dict())
    normed = [k[:-len("weight")] + "bias" for k in sd
              if k.endswith(".0.weight") and "_encoder." in k
              and k[:-len(".0.weight")] + ".0.bias" not in sd
              and not k.startswith(("feature_encoder.conv.",
                                    "context_encoder.conv."))]
    # A stem, 6 blocks of two and 2 downsamples, in each encoder.
    assert len(normed) == 2 * 15
    for k in normed:
        sd[k] = torch.randn(sd[k[:-len("bias")] + "weight"].shape[0],
                            generator=g)
    path = tmp_path / "raft_large.pth"
    torch.save({"model": {"module." + k: v for k, v in sd.items()}}, path)
    loaded = raft2d_large_checkpoint(str(path))
    assert set(loaded) == set(model.state_dict())
    fresh = traft2d.RAFT2DLarge()
    fresh.load_state_dict(loaded)
    got = convert_raft2d_large({k: v.numpy() for k, v in
                                fresh.state_dict().items()})
    want = convert_raft2d_checkpoint(str(path))
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    want_leaves = dict(jax.tree_util.tree_leaves_with_path(want))
    assert set(got_leaves) == set(want_leaves)
    for p, leaf in want_leaves.items():
        np.testing.assert_array_equal(got_leaves[p], np.asarray(leaf))


# ----------------------------------------------------------------------
# RAFT2D (native)
# ----------------------------------------------------------------------

NATIVE = dict(corr_levels=2)


@pytest.fixture(scope="module")
def native():
    """(JAX RAFT2D params from eval_shape and numpy, the port's RAFT2D with
    them loaded)."""
    net = jraft2d.RAFT2D(**NATIVE)
    x = jnp.zeros((1, H, W, 3))
    shapes = jax.eval_shape(lambda k: net.init(k, x, x, iters=1),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(11)

    def fill(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        if names[-1] == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            scale = 1e-3 if "delta_1" in names else 1.0 / np.sqrt(fan_in)
            a = rng.randn(*leaf.shape) * scale
        else:
            a = 0.1 * rng.randn(*leaf.shape)
        return a.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)["params"]
    model = traft2d.RAFT2D(**NATIVE).eval()
    model.load_state_dict(raft2d_state_dict_from_jax(params))
    return params, model


def test_raft2d_matches_jax(native):
    params, model = native
    im1, im2 = _images(6)
    want_lo, want_up = jax.jit(
        lambda p, a, b: jraft2d.RAFT2D(**NATIVE).apply(
            {"params": p}, a, b, iters=ITERS, train_mode=True))(
        params, jnp.asarray(im1), jnp.asarray(im2))
    with torch.no_grad():
        lo, up = model(_t(to_nchw(im1)), _t(to_nchw(im2)), iters=ITERS,
                       train_mode=True)
    assert up.shape == (1, H, W, 2)
    _check(lo, want_lo, **FLOW)
    _check(up, want_up, **FLOW)
    # Measured 0.063 and 0.42 pixel: both past 100 times the atol.
    assert float(lo.abs().mean()) > 100 * FLOW["atol"]
    assert float(up.abs().mean()) > 100 * FLOW["atol"]


def test_raft2d_weights_cover_every_parameter_exactly(native):
    """Every JAX leaf lands in one tensor of the port, unchanged but for
    the kernel layout, and the port has no tensor the JAX net lacks."""
    params, model = native
    sd = raft2d_state_dict_from_jax(params)
    assert set(sd) == set(model.state_dict())
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(v.numel() for v in sd.values())
    np.testing.assert_array_equal(
        sd["update.gru.convq2.weight"].numpy(),
        np.asarray(params["Scan_FlowIteration_0"]["ConvGRU_0"]["convq_2"]
                   ["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["inp_conv.bias"].numpy(), np.asarray(params["Conv_0"]["bias"]))
    assert model.update.corr1.in_channels == 2 * 81
