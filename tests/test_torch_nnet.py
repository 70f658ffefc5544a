"""The port's NNET normal stack against ``sndepth_tpu`` on the CPU, on the
same inputs and weights, made from a seed with numpy: the metrics, the
EfficientNet encoder, the normal decoder (both architectures), the patch
extraction, the closed-form 3x3 solve, D2N and N2D, Canny edges and the
propagation, the refiner (also at an odd 65x97), the whole NNET, the
weight round trip and ``NNETStage`` in float32.

The encoder runs at 64x96 with one block a stage at narrow widths (the
JAX ``NNET`` subclassed in :class:`_SmallNNET` to take that plan); the
decoder and the refiner run at their fixed widths. JAX parameters come from
``jax.eval_shape`` of ``init`` and numpy, once per module, and reach the
port through ``nnet_state_dict_from_jax``; each JAX function is jitted once
per module.

Tolerances: the metrics rtol 1e-6 (float32 means and medians over the same
values, summed in another order); every stage, handed its inputs from the
JAX side, 1e-5 relative by norm (float32 convolutions and einsums that sum
in another order); the whole NNET and ``NNETStage`` 1e-4 relative by norm
(the stages' differences carried through 40 layers). Canny edges and D2N's
``angle > 0.95`` are compared decision by decision: a pixel may differ only
where the JAX value lies within 1e-5 of the threshold (or at a
non-maximum-suppression tie), and fewer than 0.1% of them. Every output is
asserted finite.

The decoder's normal heads get a bias of +3 toward the camera (z), as a
trained decoder's normals face it: with random heads, normals at right
angles to their rays put N2D's 1 / (n . ray) and D2N's singular systems
(below) on most pixels, where float32 results part on their last bits.

D2N's float32 closed-form solve follows the last bits of its normal
equations: their median condition number is ~165 on these inputs, and
where few taps agree the system is singular and the ``det > 1e-5`` test
decides on rounding noise. Two evaluations that sum A^T A and A^T 1 in
another order (XLA, the CPU, the card) agree to ~1e-7 on the system and
part by 3-5e-5 by norm on the normals, and by O(1) at the ~2% of pixels
whose system is singular. So D2N is held piece by piece: the system within
1e-6 by norm, the solve bit for bit on the same system, and the normals end to
end within 1e-4 by norm on the pixels where a float64 solve of the same
system agrees with both to 1e-3 (at least 99% of them). The refiner, the
whole NNET and ``NNETStage`` take D2N's output handed across from the JAX
side, on both sides (:func:`_d2n_handed`), after checking that the port
hands D2N the same normals and points as JAX does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sndepth_tpu.models import efficientnet as jeff
from sndepth_tpu.models import nnet as jnnet
from sndepth_tpu.models import normal_decoder as jdec
from sndepth_tpu.ops import edges as jedges
from sndepth_tpu.ops import patches as jpatches
from sndepth_tpu.utils import metrics as jmetrics
from sndepth_tpu.utils.convert_weights import (convert_efficientnet,
                                               convert_normal_decoder)
from sndepth_tpu_torch.models import efficientnet as teff
from sndepth_tpu_torch.models import nnet as tnnet
from sndepth_tpu_torch.ops import edges as tedges
from sndepth_tpu_torch.ops import patches as tpatches
from sndepth_tpu_torch.utils import metrics as tmetrics
from sndepth_tpu_torch.utils.threads import torch_threads
from sndepth_tpu_torch.utils.weights import nnet_state_dict_from_jax


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


H, W = 64, 96
STAGE_TOL = 1e-5
WHOLE_TOL = 1e-4
# One block a stage, narrow: (in, out, kernel, stride, expand, repeats).
BLOCKS = tuple(jeff.BlockSpec(*b) for b in (
    (16, 8, 3, 1, 1, 1), (8, 12, 3, 2, 6, 1), (12, 16, 5, 2, 6, 1),
    (16, 24, 3, 2, 6, 1), (24, 32, 5, 1, 6, 1), (32, 40, 5, 2, 6, 1),
    (40, 48, 3, 1, 6, 1)))
TBLOCKS = tuple(teff.BlockSpec(*(getattr(b, f) for f in (
    "in_ch", "out_ch", "kernel", "stride", "expand", "repeats")))
    for b in BLOCKS)
STEM, HEAD = 16, 64


class _SmallNNET(jnnet.NNET):
    """The JAX NNET with the test's encoder plan."""

    def setup(self):
        self.encoder = jeff.EfficientNetEncoder(
            blocks=BLOCKS, stem_ch=STEM, head_ch=HEAD, dtype=self.dtype)
        self.decoder = jdec.NormalDecoder(architecture=self.architecture,
                                          dtype=self.dtype)
        self.refiner = jnnet.NNETRefiner(dtype=self.dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _rel(got, want):
    """Relative error by norm, after asserting shapes and finiteness."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _inputs(seed, b=1, h=H, w=W):
    """pre_depth_log2, rgb (NHWC, 0..1), edge inputs and canny, numpy."""
    rng = np.random.RandomState(seed)
    pre = (rng.rand(b, h, w) * 2.0 + 0.5).astype(np.float32)
    rgb = rng.rand(b, h, w, 3).astype(np.float32)
    edge_in = np.asarray(jax.jit(jedges.edge_model_inputs)(
        jnnet.bgr_preprocess(jnp.asarray(rgb))))
    return pre, rgb, edge_in, edge_in[..., :1]


def _variables(architecture, seed):
    model = _SmallNNET(architecture=architecture)
    args = tuple(jnp.asarray(a) for a in _inputs(0))
    shapes = jax.eval_shape(lambda k: model.init(k, *args),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            a = rng.randn(*leaf.shape) / np.sqrt(fan_in)
        elif name == "var":
            a = 0.5 + rng.rand(*leaf.shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.randn(*leaf.shape)
        else:                                    # bias, mean
            a = 0.1 * rng.randn(*leaf.shape)
        if name == "bias" and _is_normal_head(path):
            a[2] += 3.0                          # normals face the camera
        return a.astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def _is_normal_head(path) -> bool:
    """The decoder's last layers, whose outputs are normal + kappa."""
    keys = [p.key for p in path]
    return "decoder" in keys and (keys[-2:] == ["Conv_1", "bias"]
                                  or keys[-2:] == ["Dense_3", "bias"])


_PAIRS: dict = {}


def _pair(arch):
    """(architecture, JAX model, its variables, the port's NNET with them),
    built once per module and architecture."""
    if arch not in _PAIRS:
        model, variables = _variables(arch, 1 + (arch == "BN"))
        port = tnnet.NNET(arch, blocks=TBLOCKS, stem_ch=STEM,
                          head_ch=HEAD).eval()
        port.load_state_dict(nnet_state_dict_from_jax(
            variables["params"], variables["batch_stats"]))
        _PAIRS[arch] = arch, model, variables, port
    return _PAIRS[arch]


@pytest.fixture(scope="module", params=["GN", "BN"])
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def gn():
    return _pair("GN")


def _sub(variables, name):
    out = {"params": variables["params"][name]}
    if name in variables.get("batch_stats", {}):
        out["batch_stats"] = variables["batch_stats"][name]
    return out


def _jax_d2n(init_norm, pre):
    """JAX's D2N output for these decoder normals and log2-depths."""
    h, w = pre.shape[1:]
    points = jnnet.camera_grid(pre.shape[0], h, w) * jnp.exp2(
        jnp.asarray(pre))[..., None]
    return tuple(np.asarray(o) for o in jax.jit(jnnet.d2n_least_squares)(
        jnp.asarray(init_norm), points)), np.asarray(points)


def _d2n_handed(mp, handed, seen=None):
    """Make both sides' refiners take ``handed`` (JAX's D2N output) instead
    of solving D2N themselves; the port's D2N inputs go into ``seen``."""
    mp.setattr(jnnet, "d2n_least_squares",
               lambda n, p: tuple(map(jnp.asarray, handed)))

    def port_d2n(n, p):
        if seen is not None:
            seen["inputs"] = (n, p)
        return tuple(_t(o).to(n.device) for o in handed)
    mp.setattr(tnnet, "d2n_least_squares", port_d2n)


@pytest.fixture(scope="module")
def jax_stages(pair):
    """Each JAX stage's outputs on one input, jitted once: the encoder's
    features, the decoder's maps, D2N's output, and the refiner's and the
    whole NNET's outputs with that D2N output handed in."""
    arch, model, variables, _ = pair
    pre, rgb, edge_in, canny = _inputs(3)
    model_in = jnnet.bgr_preprocess(jnp.asarray(rgb))
    enc = jeff.EfficientNetEncoder(blocks=BLOCKS, stem_ch=STEM, head_ch=HEAD)
    dec = jdec.NormalDecoder(architecture=arch)
    ref = jnnet.NNETRefiner()
    feats = jax.jit(lambda v, x: enc.apply(v, x))(
        _sub(variables, "encoder"), model_in / 255.0)
    outs = jax.jit(lambda v, f: dec.apply(v, f)[0])(
        _sub(variables, "decoder"), feats)
    init_norm = outs[-1][..., :3]
    d2n, points = _jax_d2n(init_norm, pre)
    with pytest.MonkeyPatch.context() as mp:
        _d2n_handed(mp, d2n)
        refined = jax.jit(lambda v, *a: ref.apply(v, *a))(
            _sub(variables, "refiner"), jnp.asarray(pre), model_in,
            init_norm, jnp.asarray(edge_in), jnp.asarray(canny))
        whole = jax.jit(lambda v, *a: model.apply(v, *a))(
            variables, *map(jnp.asarray, (pre, rgb, edge_in, canny)))
    return {"inputs": (pre, rgb, edge_in, canny), "model_in": model_in,
            "feats": feats, "outs": outs, "d2n": d2n, "points": points,
            "refined": refined, "whole": whole}


def _check_d2n_inputs(seen, init_norm, points, tol=STAGE_TOL):
    """The port handed D2N the normals and points JAX did."""
    n, p = seen["inputs"]
    assert _rel(n, init_norm) <= tol
    assert _rel(p, points) <= tol


# --- metrics ---------------------------------------------------------------

@pytest.mark.parametrize("n", [1001, 1000])
def test_depth_metrics_match(n):
    rng = np.random.RandomState(n)
    gt = (rng.rand(n) * 70 + 1).astype(np.float32)
    pred = (gt * (0.8 + 0.4 * rng.rand(n))).astype(np.float32)
    mask = rng.rand(n) > 0.2
    for got, want in (
            (tmetrics.compute_depth_errors(gt, pred),
             jmetrics.compute_depth_errors(gt, pred)),
            (tmetrics.median_scaled_depth_errors(gt, pred * 3.0, mask),
             jmetrics.median_scaled_depth_errors(gt, pred * 3.0, mask))):
        assert set(got) == set(want) == set(tmetrics.DEPTH_ERROR_NAMES)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("n", [24 * 32, 24 * 32 - 1])
def test_normal_metrics_match(n):
    rng = np.random.RandomState(n)
    pred = rng.randn(n, 3).astype(np.float32)
    gt = (pred + 0.3 * rng.randn(n, 3)).astype(np.float32)
    mask = rng.rand(n) > 0.1
    err_t = tmetrics.normal_angular_errors(pred, gt, mask)
    err_j = jmetrics.normal_angular_errors(pred, gt, mask)
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), rtol=1e-6)
    got = tmetrics.compute_normal_errors(np.asarray(err_j))
    want = jmetrics.compute_normal_errors(err_j)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


def test_confusion_matrix_and_mean_iou_match():
    rng = np.random.RandomState(5)
    pred = rng.randint(0, 5, 4000)
    target = rng.randint(0, 6, 4000) % 5
    target[target == 3] = 4                     # class 3 never a target
    pred[pred == 3] = 0                         # nor predicted: IoU 0
    np.testing.assert_array_equal(
        tmetrics.confusion_matrix(pred, target, 5).numpy(),
        np.asarray(jmetrics.confusion_matrix(pred, target, 5)))
    np.testing.assert_allclose(float(tmetrics.mean_iou(pred, target, 5)),
                               float(jmetrics.mean_iou(pred, target, 5)),
                               rtol=1e-6)


# --- ops ---------------------------------------------------------------------

def test_extract_patches_tap_last_matches():
    x = np.random.RandomState(0).randn(2, 13, 17, 3).astype(np.float32)
    got = tpatches.extract_patches_tap_last(_t(x), 9, 4)
    want = jpatches.extract_patches_tap_last(jnp.asarray(x), 9, 4)
    assert _rel(got, want) <= STAGE_TOL


def test_camera_grid_matches():
    got = tnnet.camera_grid(2, 65, 97)
    want = jnnet.camera_grid(2, 65, 97)
    assert _rel(got, want) <= STAGE_TOL
    assert float((got - _t(want)).abs().max()) <= 2.4e-7   # 2 ulps of 1


def test_solve3x3_matches_with_singular_systems():
    rng = np.random.RandomState(1)
    a = rng.randn(64, 3, 3).astype(np.float32)
    ata = (a @ a.transpose(0, 2, 1)).astype(np.float32)
    ata[:8] = 0.0                                       # det 0
    ata[8:16] = np.outer(*(rng.randn(2, 3))).astype(np.float32)  # rank 1
    ata[16:24] *= 1e-3                                   # det <= 1e-5
    atb = rng.randn(64, 3, 1).astype(np.float32)
    got = tnnet._solve3x3(_t(ata), _t(atb))
    want = jnnet._solve3x3(jnp.asarray(ata), jnp.asarray(atb))
    assert _rel(got, want) <= STAGE_TOL
    # The identity fallback returns b itself.
    np.testing.assert_array_equal(got[:8].numpy(), atb[:8])


def _normals(seed, b=1, h=H, w=W):
    """Smooth unit normals, so that neighbours agree past 0.95 often."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / 20.0
    n = np.stack([np.sin(xx), np.cos(yy), 2.0 + 0 * xx], -1)[None]
    n = n + 0.3 * rng.randn(b, h, w, 3)
    return (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)


def _points(seed, b=1, h=H, w=W):
    rng = np.random.RandomState(seed)
    depth = np.exp2(1.0 + rng.rand(b, h, w)).astype(np.float32)
    return np.asarray(jnnet.camera_grid(b, h, w)) * depth[..., None]


@pytest.fixture(scope="module")
def d2n_case():
    norm, pts = _normals(4), _points(5)
    want = jax.jit(jnnet.d2n_least_squares)(jnp.asarray(norm),
                                           jnp.asarray(pts))
    return norm, pts, want


def test_d2n_least_squares_matches(d2n_case):
    """Piece by piece (see the module docstring): the system, the solve of
    JAX's system, then the normals end to end on determined pixels."""
    norm, pts, want = d2n_case
    w_norm, w_angle, w_patches = (np.asarray(w) for w in want)
    got = tnnet.d2n_least_squares(_t(norm), _t(pts))
    assert _rel(got[1], w_angle) <= STAGE_TOL
    assert _rel(got[2], w_patches) <= STAGE_TOL
    a = np.where((w_angle > jnnet.THRESH)[:, :, :, None, :], w_patches, 0)
    j_ata, j_atb = jax.jit(lambda a: (
        jnp.einsum("bhwit,bhwjt->bhwij", a, a), jnp.sum(a, -1)[..., None]))(
        jnp.asarray(a))
    ata, atb, _, _ = tnnet.normal_equations(_t(norm), _t(pts))
    assert _rel(ata, j_ata) <= 1e-6 and _rel(atb, j_atb) <= 1e-6
    # Op by op on both sides (a jitted solve contracts products into fused
    # multiply-adds, which moves these cancelling cofactors).
    np.testing.assert_array_equal(
        tnnet._solve3x3(_t(j_ata), _t(j_atb)).numpy(),
        np.asarray(jnnet._solve3x3(j_ata, j_atb)))
    # A float64 solve of the same system; pixels where both float32
    # results lie within 1e-3 of it are determined by float32 arithmetic.
    a64 = a.astype(np.float64)
    ata64, atb64 = np.einsum("bhwit,bhwjt->bhwij", a64, a64), a64.sum(-1)
    ok = np.linalg.det(ata64) > 1e-5
    x = np.linalg.solve(np.where(ok[..., None, None], ata64, np.eye(3)),
                        atb64[..., None])[..., 0]
    x = np.where(ok[..., None], x, atb64)
    n64 = x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12) * 10
    g_norm = got[0].numpy()
    assert np.isfinite(g_norm).all()
    determined = ((np.abs(w_norm - n64).max(-1) <= 1e-2)
                  & (np.abs(g_norm - n64).max(-1) <= 1e-2))
    assert determined.mean() >= 0.99
    assert _rel(g_norm[determined], w_norm[determined]) <= WHOLE_TOL


def _decisions_match(got: np.ndarray, want: np.ndarray,
                     near: np.ndarray) -> None:
    """Boolean maps equal except where ``near`` (a JAX value within 1e-5 of
    its threshold or at a tie), and on fewer than 0.1% of the pixels."""
    differ = got != want
    assert not (differ & ~near).any(), int((differ & ~near).sum())
    assert differ.mean() < 1e-3


def test_d2n_angle_decisions_match(d2n_case):
    norm, pts, want = d2n_case
    _, angle, _ = tnnet.d2n_least_squares(_t(norm), _t(pts))
    wa = np.asarray(want[1])
    assert (wa > jnnet.THRESH).mean() > 0.2       # the threshold matters
    _decisions_match(angle.numpy() > tnnet.THRESH, wa > jnnet.THRESH,
                     np.abs(wa - jnnet.THRESH) <= 1e-5)


def test_n2d_depth_matches(d2n_case):
    norm, pts, (_, angle, patches) = d2n_case
    grid = np.asarray(jnnet.camera_grid(1, H, W))
    want = jax.jit(jnnet.n2d_depth)(jnp.asarray(norm), jnp.asarray(grid),
                                    angle, patches)
    got = tnnet.n2d_depth(_t(norm), _t(grid), _t(angle), _t(patches))
    assert _rel(got, want) <= STAGE_TOL


def test_propagate_matches():
    rng = np.random.RandomState(6)
    data = rng.randn(2, 11, 13, 3).astype(np.float32)
    ws = [rng.rand(2, 11, 13, 1).astype(np.float32) for _ in range(4)]
    got = tedges.propagate(_t(data), *map(_t, ws))
    want = jedges.propagate(jnp.asarray(data), *map(jnp.asarray, ws))
    assert _rel(got, want) <= STAGE_TOL


def test_canny_edges_match():
    """Decision by decision on random images and on smooth ones with
    edges: strong, weak and non-maximum pixels all occur."""
    rng = np.random.RandomState(7)
    yy, xx = np.mgrid[0:H, 0:W]
    smooth = (np.stack([np.sin(xx / 7.0), np.cos(yy / 5.0),
                        (xx > W / 2) * 1.0], -1) * 100 + 120)[None]
    imgs = np.concatenate([rng.rand(1, H, W, 3) * 255, smooth]).astype(
        np.float32)
    got = tedges.canny_edges(_t(imgs)).numpy()[..., 0] < 0.5
    want_map = np.asarray(jax.jit(jedges.canny_edges)(jnp.asarray(imgs)))
    want = want_map[..., 0] < 0.5
    assert 0.01 < want.mean() < 0.5
    # The JAX intermediates where a decision could tip: the NMS magnitude
    # near 100 or 220, and gradient magnitudes equal to a neighbour's.
    gray = jedges.bgr_to_gray(jnp.asarray(imgs))
    gmin = gray.min(axis=(1, 2), keepdims=True)
    gmax = gray.max(axis=(1, 2), keepdims=True)
    gx, gy = jedges._sobel((gray - gmin) / (gmax - gmin + 1e-12) * 255.0)
    mag = np.asarray(jnp.abs(gx) + jnp.abs(gy))
    near = (np.abs(mag - 100.0) <= 1e-5 * 100) | (np.abs(mag - 220.0)
                                                 <= 1e-5 * 220)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                shifted = np.roll(mag, (dy, dx), axis=(1, 2))
                near |= np.abs(mag - shifted) <= 1e-5 * np.maximum(mag, 1)
    # A tip propagates through hysteresis: grow the region by its passes.
    grown = near.copy()
    for _ in range(8):
        grown = np.asarray(jax.lax.reduce_window(
            grown.astype(np.float32), 0.0, jax.lax.max, (1, 3, 3),
            (1, 1, 1), [(0, 0), (1, 1), (1, 1)])) > 0
    _decisions_match(got, want, grown)
    np.testing.assert_array_equal(
        tedges.edge_model_inputs(_t(imgs))[..., 1:].numpy(),
        np.asarray(jedges.edge_model_inputs(jnp.asarray(imgs)))[..., 1:])


# --- nets --------------------------------------------------------------------

def test_state_dict_keys_are_the_reference_names(pair):
    arch, _, _, port = pair
    keys = set(port.state_dict())
    for key in ("encoder.conv_stem.weight", "encoder.bn1.running_var",
                "encoder.blocks.0.0.conv_dw.weight",
                "encoder.blocks.0.0.se.conv_reduce.bias",
                "encoder.blocks.3.0.conv_pwl.weight",
                "encoder.blocks.6.0.bn3.running_mean",
                "encoder.conv_head.weight", "encoder.bn2.bias",
                "decoder.conv2.weight", "decoder.up4._net.3.weight",
                "decoder.up1._net.4.bias", "decoder.out_conv_res8.bias",
                "decoder.out_conv_res1.6.weight",
                "refiner.noise_enc2.10.weight",
                "refiner.edge_weight.0.bias"):
        assert key in keys, key
    assert ("decoder.up2._net.1.running_mean" in keys) == (arch == "BN")
    assert "encoder.blocks.0.0.conv_pwl.weight" not in keys


def test_weight_round_trip_through_the_jax_converters_is_exact(pair):
    """The encoder's and the decoder's state_dicts through
    ``convert_efficientnet`` and ``convert_normal_decoder`` give the JAX
    variables back bit for bit."""
    arch, _, variables, port = pair
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    enc = convert_efficientnet(
        {k[len("encoder."):]: v for k, v in sd.items()
         if k.startswith("encoder.")}, blocks=BLOCKS)
    dec = convert_normal_decoder(
        {"module." + k[len("decoder."):]: v for k, v in sd.items()
         if k.startswith("decoder.")}, arch)
    want_enc = {"params": variables["params"]["encoder"],
                "batch_stats": variables["batch_stats"]["encoder"]}
    want_dec = _sub(variables, "decoder")
    for got, want in ((enc, want_enc), (dec, want_dec)):
        g = dict(jax.tree_util.tree_leaves_with_path(got))
        w = dict(jax.tree_util.tree_leaves_with_path(want))
        assert set(g) == set(w)
        for path, leaf in w.items():
            np.testing.assert_array_equal(np.asarray(g[path]), leaf,
                                          err_msg=jax.tree_util.keystr(path))


def test_encoder_features_match(pair, jax_stages):
    _, _, _, port = pair
    x = _nchw(np.asarray(jax_stages["model_in"]) / 255.0)
    with torch.no_grad():
        feats = port.encoder(x)
    want = jax_stages["feats"]
    assert set(feats) == set(want)
    for k, v in want.items():
        assert _rel(feats[k].permute(0, 2, 3, 1), v) <= STAGE_TOL, k


def test_decoder_outputs_match(pair, jax_stages):
    _, _, _, port = pair
    feats = {k: _nchw(v) for k, v in jax_stages["feats"].items()}
    with torch.no_grad():
        outs = port.decoder(feats)
    assert len(outs) == 4
    for got, want in zip(outs, jax_stages["outs"]):
        assert _rel(got, want) <= STAGE_TOL


def test_refiner_matches(pair, jax_stages, monkeypatch):
    _, _, _, port = pair
    pre, _, edge_in, canny = jax_stages["inputs"]
    init_norm = jax_stages["outs"][-1][..., :3]
    seen = {}
    _d2n_handed(monkeypatch, jax_stages["d2n"], seen)
    with torch.no_grad():
        got = port.refiner(_t(pre), _t(jax_stages["model_in"]),
                           _t(init_norm), _t(edge_in), _t(canny))
    _check_d2n_inputs(seen, init_norm, jax_stages["points"])
    for g, w in zip(got, jax_stages["refined"]):
        assert _rel(g, w) <= STAGE_TOL


def test_refiner_matches_on_an_odd_grid(gn, monkeypatch):
    """65x97: the max pool pads asymmetrically with -inf, and the nearest
    resize back from 33x49 takes half-pixel centres."""
    _, _, variables, port = gn
    pre, rgb, edge_in, canny = _inputs(8, h=65, w=97)
    model_in = jnnet.bgr_preprocess(jnp.asarray(rgb))
    init_norm = _normals(9, h=65, w=97)
    d2n, points = _jax_d2n(init_norm, pre)
    seen = {}
    _d2n_handed(monkeypatch, d2n, seen)
    ref = jnnet.NNETRefiner()
    want = jax.jit(lambda v, *a: ref.apply(v, *a))(
        _sub(variables, "refiner"), jnp.asarray(pre), model_in,
        jnp.asarray(init_norm), jnp.asarray(edge_in), jnp.asarray(canny))
    with torch.no_grad():
        got = port.refiner(_t(pre), _t(model_in), _t(init_norm),
                           _t(edge_in), _t(canny))
    _check_d2n_inputs(seen, init_norm, points)
    for g, w in zip(got, want):
        assert _rel(g, w) <= STAGE_TOL


def test_whole_nnet_matches(pair, jax_stages, monkeypatch):
    _, _, _, port = pair
    seen = {}
    _d2n_handed(monkeypatch, jax_stages["d2n"], seen)
    with torch.no_grad():
        norm, depth, outs = port(*map(_t, jax_stages["inputs"]))
    _check_d2n_inputs(seen, jax_stages["outs"][-1][..., :3],
                      jax_stages["points"], WHOLE_TOL)
    w_norm, w_depth, (w_outs, _, _) = jax_stages["whole"]
    assert _rel(norm, w_norm) <= WHOLE_TOL
    assert _rel(depth, w_depth) <= WHOLE_TOL
    for g, w in zip(outs, w_outs):
        assert _rel(g, w) <= WHOLE_TOL


def test_nnet_stage_float32_matches(gn, monkeypatch):
    """``NNETStage`` in float32 against the JAX stage serving the same
    small NNET: Canny edges, BGR preprocessing and the whole net."""
    from sndepth_tpu import pipelines as jpipe
    from sndepth_tpu_torch import pipelines as tpipe
    arch, model, variables, port = gn
    jstage = jpipe.NNETStage(variables=variables, dtype=jnp.float32)
    jstage.model = model                      # traced at the first call
    tstage = tpipe.NNETStage(dtype=torch.float32, device="cpu", model=port)
    rng = np.random.RandomState(10)
    pre = (rng.rand(2, H, W) * 3.0).astype(np.float32)
    rgb = rng.rand(2, H, W, 3).astype(np.float32)
    enc = jeff.EfficientNetEncoder(blocks=BLOCKS, stem_ch=STEM, head_ch=HEAD)
    dec = jdec.NormalDecoder(architecture=arch)
    init_norm = jax.jit(lambda v, w, x: dec.apply(w, enc.apply(v, x))[0][-1])(
        _sub(variables, "encoder"), _sub(variables, "decoder"),
        jnnet.bgr_preprocess(jnp.asarray(rgb)) / 255.0)[..., :3]
    d2n, points = _jax_d2n(init_norm, pre)
    seen = {}
    _d2n_handed(monkeypatch, d2n, seen)
    want = jstage(jnp.asarray(pre), jnp.asarray(rgb))
    got = tstage(_t(pre), _t(rgb).permute(0, 3, 1, 2))
    _check_d2n_inputs(seen, init_norm, points, WHOLE_TOL)
    assert _rel(got["normals"], want["normals"]) <= WHOLE_TOL
    assert _rel(got["depth"], want["depth"]) <= WHOLE_TOL
    _assert_unit_normals(got["normals"], want["normals"])


def _assert_unit_normals(got, want):
    """Unit normals, but where the last propagation pulls a zero border in
    at full weight (an edge weight clipped to 1), as the JAX stage does."""
    norms = torch.linalg.vector_norm(got, dim=-1).numpy()
    zero = norms == 0
    np.testing.assert_array_equal(
        zero, np.linalg.norm(np.asarray(want), axis=-1) == 0)
    inner = np.zeros_like(zero)
    inner[:, 1:-1, 1:-1] = True
    assert not (zero & inner).any()
    np.testing.assert_allclose(norms[~zero], 1.0, atol=1e-5)
