"""The port's UniAD / BEVFormer tracking stack against the JAX package on
the CPU, on the same inputs and weights made from a seed with numpy: the
box codecs, the positional embedding and GridMask (its draws handed
across), the rotated IoU, ``ms_deformable_attention`` (under the JAX
package's default and ``natural`` coordinate layouts and its query-chunked
path), each attention module with spread sampling offsets (and the chunked
dense paths), DCNv2 at both strides with its gradients, the BEV shift, the
pillar projection, the tracker's lifecycle, the memory bank and QIM (with
fully masked attention rows), the decoder's top k, ResNet + FPN in both
styles and norms, two chained ``UniADTrack`` frames and the carried
dtypes, and the weight round trip through ``convert_uniad``; also the
port's float64 evaluation, the yardstick of its card-against-CPU check,
against its float32 one (2e-5 by norm).

JAX parameters come from ``jax.eval_shape`` of each module's ``init`` and
numpy (kernels normal over sqrt(fan_in), the sampling offsets' three times
that so that taps spread over pixels and leave the planes, norm scales 1 +
0.1 normal, other biases 0.1 normal, embeddings standard normal) and reach
the port through ``uniad_state_dict_from_jax``; the port's own seeded
weights go back through ``convert_uniad``. On the CPU the sampler is K5's
plain version, as JAX's is an XLA gather.

Tolerances: the sampler and the attention modules atol 2e-5 + rtol 1e-5
(sums of at most 32 bilinear samples in another order), DCN atol 1e-4 +
rtol 1e-4 (a 2304-term contraction), its gradients 1e-4 relative by norm;
the networks atol 1e-4 + rtol 1e-4 on the BEV, the logits and the track
fields, the boxes 1e-4 relative (their sizes are exponentials of the
regression); the codecs and IoU rtol 1e-5; integer outputs (track ids,
top-k indices, masks) equal. The tracker's decisions are compared only
where every score is at least 1e-3 from its thresholds (asserted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sndepth_tpu.models import bevformer as jbev
from sndepth_tpu.models import coders as jcod
from sndepth_tpu.models import deformable as jdef
from sndepth_tpu.models import track_runtime as jtr
from sndepth_tpu.models import uniad_track as jua
from sndepth_tpu.ops import box_iou as jiou
from sndepth_tpu.utils import uniad as jut
from sndepth_tpu.utils.convert_weights import convert_uniad
from sndepth_tpu_torch.models import bevformer as tbev
from sndepth_tpu_torch.models import coders as tcod
from sndepth_tpu_torch.models import deformable as tdef
from sndepth_tpu_torch.models import track_runtime as ttr
from sndepth_tpu_torch.models import uniad_track as tua
from sndepth_tpu_torch.ops import box_iou as tiou
from sndepth_tpu_torch.utils import uniad as tut
from sndepth_tpu_torch.utils import weights as tw
from sndepth_tpu_torch.utils.layout import to_nchw
from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


SAMPLER = dict(atol=2e-5, rtol=1e-5)
NET = dict(atol=1e-4, rtol=1e-4)
EMBEDDINGS = ("bev_embedding", "query_embedding", "level_embeds",
              "cams_embeds")
SMALL = dict(num_query=12, num_classes=3, embed_dims=32, bev_h=4, bev_w=4,
             num_cams=2, encoder_layers=1, decoder_layers=2,
             backbone_blocks=(1, 1, 1, 1), mem_len=2)
BLOCKS = (1, 1, 1, 1)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _check(got, want, **tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, **tol)


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert np.isfinite(got).all()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _fill(shapes, seed=0):
    """numpy parameters of the shapes of a JAX parameter tree."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        parent = path[-2].key if len(path) > 1 else ""
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            if len(leaf.shape) == 3 and parent == "out":
                fan_in = int(np.prod(leaf.shape[:2]))
            a = rng.randn(*leaf.shape) / np.sqrt(fan_in)
            if parent == "sampling_offsets":
                a = a * 3.0
        elif name == "scale":
            a = 1.0 + 0.1 * rng.randn(*leaf.shape)
        elif name in EMBEDDINGS:
            a = rng.randn(*leaf.shape)
        else:
            a = 0.1 * rng.randn(*leaf.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _params(module, *args, seed=0, method=None):
    shapes = jax.eval_shape(
        lambda k: module.init(k, *args, method=method),
        jax.random.PRNGKey(0))["params"]
    return _fill(shapes, seed)


# ----------------------------------------------------------------------
# Utilities, IoU, the decoder's top k
# ----------------------------------------------------------------------

def test_box_codecs_embedding_and_activation_match_jax():
    rng = np.random.RandomState(1)
    boxes = np.concatenate([rng.uniform(-20, 20, (6, 3)),
                            rng.uniform(0.5, 4.0, (6, 3)),
                            rng.uniform(-3.1, 3.1, (6, 1)),
                            rng.uniform(-3, 3, (6, 2))], -1).astype(np.float32)
    for n in (7, 9):
        norm = jax.jit(jut.normalize_bbox)(jnp.asarray(boxes[:, :n]))
        _check(tut.normalize_bbox(_t(boxes[:, :n])), norm, rtol=1e-5,
               atol=1e-6)
        _check(tut.denormalize_bbox(_t(norm)),
               jax.jit(jut.denormalize_bbox)(norm), rtol=1e-5, atol=1e-6)
    pos = rng.rand(3, 5, 2).astype(np.float32)
    _check(tut.pos2posemb2d(_t(pos), 16), jax.jit(
        jut.pos2posemb2d, static_argnums=1)(jnp.asarray(pos), 16),
        rtol=1e-5, atol=1e-5)
    ip = rng.randn(4, 5).astype(np.float32)
    _check(tut.bivariate_gaussian_activation(_t(ip)),
           jax.jit(jut.bivariate_gaussian_activation)(jnp.asarray(ip)),
           rtol=1e-6)


@pytest.mark.parametrize("seed,prob", [(0, 1.0), (3, 1.0), (5, 0.0)])
def test_grid_mask_matches_jax_with_its_draws(seed, prob):
    """The JAX draws (split, pitch, offsets, apply) handed across."""
    rng = np.random.RandomState(seed)
    imgs = rng.rand(2, 13, 17, 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jax.jit(lambda k, x: jut.grid_mask(k, x, prob=prob))(
        key, jnp.asarray(imgs))
    k_apply, k_d, k_ox, k_oy = jax.random.split(key, 4)
    draws = {"d": int(jax.random.randint(k_d, (), 2, min(8, 13) + 1)),
             "off_x": int(jax.random.randint(k_ox, (), 0, 8)),
             "off_y": int(jax.random.randint(k_oy, (), 0, 8)),
             "apply": bool(jax.random.uniform(k_apply, ()) < prob)}
    got = tut.grid_mask(torch.from_numpy(to_nchw(imgs)), **draws)
    np.testing.assert_array_equal(_np(got), to_nchw(want))


def test_box_iou_matches_jax():
    rng = np.random.RandomState(2)

    def boxes(n):
        return np.concatenate([rng.uniform(-2, 2, (n, 3)),
                               rng.uniform(1, 3, (n, 3)),
                               rng.uniform(-3.1, 3.1, (n, 1))],
                              -1).astype(np.float32)

    b1, b2 = boxes(7), boxes(5)
    b2[0] = b1[0]                        # a box against itself: IoU 1
    cols = [0, 1, 3, 4, 6]
    _check(tiou.box_corners(_t(b1[:, cols])),
           jax.jit(jiou.box_corners)(jnp.asarray(b1[:, cols])), rtol=1e-5,
           atol=1e-6)
    bev = tiou.rotated_bev_iou(_t(b1[:, cols]), _t(b2[:, cols]))
    _check(bev, jax.jit(jiou.rotated_bev_iou)(jnp.asarray(b1[:, cols]),
                                              jnp.asarray(b2[:, cols])),
           rtol=1e-5, atol=1e-6)
    assert abs(float(bev[0, 0]) - 1.0) < 1e-5
    assert float(bev.max()) <= 1.0 + 1e-6
    want = jax.jit(jiou.iou_3d)(jnp.asarray(b1), jnp.asarray(b2))
    _check(tiou.iou_3d(_t(b1), _t(b2)), want, rtol=1e-5, atol=1e-6)
    assert 0 < float((np.asarray(want) > 0).mean()) < 1


def test_nms_free_decode_breaks_ties_as_jax():
    """jax.lax.top_k keeps the lower index among equal scores; so does the
    port's stable sort, on class scores and on track scores."""
    rng = np.random.RandomState(4)
    logits = rng.randn(20, 3).astype(np.float32)
    logits[5] = logits[2]                  # tied classes across queries
    logits[7, 1] = logits[7, 0]
    boxes = rng.randn(20, 10).astype(np.float32)
    track = np.round(rng.rand(20), 1).astype(np.float32)   # many ties
    obj = rng.randint(-1, 5, 20).astype(np.int32)
    for kwargs in ({}, {"track_scores": track, "obj_idxes": obj},
                   {"score_threshold": 0.5,
                    "post_center_range": [-1, -1, -1, 1, 1, 1]}):
        arrays = {k: jnp.asarray(v) for k, v in kwargs.items()
                  if isinstance(v, np.ndarray)}
        static = {k: v for k, v in kwargs.items() if k not in arrays}
        want = jax.jit(lambda lg, bx, arr: jcod.nms_free_decode(
            lg, bx, max_num=8, **arr, **static))(
            jnp.asarray(logits), jnp.asarray(boxes), arrays)
        got = tcod.nms_free_decode(
            _t(logits), _t(boxes), max_num=8,
            **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
               for k, v in kwargs.items()})
        assert set(got) == set(want)
        for k in ("query_idx", "labels", "valid", "obj_idxes"):
            if k in want:
                np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                              err_msg=k)
        _check(got["scores"], want["scores"], rtol=1e-6)
        _check(got["bboxes"], want["bboxes"], rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# Deformable attention, DCN, the BEV shift
# ----------------------------------------------------------------------

def _msda_inputs(seed, nq=32, b=2, heads=4, dim=8, P=4,
                 shapes=((6, 8), (3, 4))):
    rng = np.random.RandomState(seed)
    nk = sum(h * w for h, w in shapes)
    value = rng.randn(b, nk, heads, dim).astype(np.float32)
    # Some locations outside [0, 1]: those taps read zeros.
    loc = rng.uniform(-0.2, 1.2, (b, nq, heads, len(shapes), P, 2)
                      ).astype(np.float32)
    wgt = rng.rand(b, nq, heads, len(shapes), P).astype(np.float32)
    return value, list(shapes), loc, wgt


@pytest.mark.parametrize("layout", ["pmajor", "natural"])
def test_ms_deformable_attention_matches_jax(layout, monkeypatch):
    """nq P = 128, so the JAX default takes its point-major layout; the
    port's natural (nq, P) layout computes the same sums."""
    monkeypatch.setenv("SNDEPTH_MSDA_COORDS", layout)
    value, shapes, loc, wgt = _msda_inputs(7)
    want = jax.jit(lambda v, lc, wg: jdef.ms_deformable_attention(
        v, shapes, lc, wg))(jnp.asarray(value), jnp.asarray(loc),
                            jnp.asarray(wgt))
    got = tdef.ms_deformable_attention(_t(value), shapes, _t(loc), _t(wgt))
    _check(got, want, **SAMPLER)


def test_ms_deformable_attention_matches_the_chunked_jax_path(monkeypatch):
    """The JAX query-chunked ``lax.map`` (padded: 25 queries in chunks of
    8) is exact per query: the port, which runs every query at once,
    equals it."""
    monkeypatch.setattr(jdef, "_Q_CHUNK_THRESHOLD", 8)
    monkeypatch.setattr(jdef, "_Q_CHUNK_TARGET", 8)
    value, shapes, loc, wgt = _msda_inputs(8, nq=25, P=3)
    want = jax.jit(lambda v, lc, wg: jdef.ms_deformable_attention(
        v, shapes, lc, wg))(jnp.asarray(value), jnp.asarray(loc),
                            jnp.asarray(wgt))
    got = tdef.ms_deformable_attention(_t(value), shapes, _t(loc), _t(wgt))
    _check(got, want, **SAMPLER)


def _attention_case(kind, rng):
    b, nq, c = 2, 24, 32
    q = rng.randn(b, nq, c).astype(np.float32)
    pos = rng.randn(b, nq, c).astype(np.float32)
    if kind == "msda3d":
        shapes = ((5, 7), (3, 4))
        v = rng.randn(b, sum(h * w for h, w in shapes), c).astype(np.float32)
        ref = rng.rand(b, nq, 2, 2).astype(np.float32)
        return (jdef.MSDeformableAttention3D(c, 4, len(shapes), 4),
                tdef.MSDeformableAttention3D(c, 4, len(shapes), 4),
                (q, v, ref, shapes), "msda3d")
    if kind in ("tsa", "tsa_no_prev"):
        shapes = ((4, 6),)
        prev = (None if kind == "tsa_no_prev"
                else rng.randn(b, nq, c).astype(np.float32))
        ref = rng.rand(b, nq, 1, 2).astype(np.float32)
        return (jdef.TemporalSelfAttention(c, 4), tdef.TemporalSelfAttention(
            c, 4), (q, prev, ref, shapes, pos), "tsa")
    if kind == "cda":
        shapes = ((4, 6),)
        v = rng.randn(b, 24, c).astype(np.float32)
        ref = rng.rand(b, nq, 2).astype(np.float32)
        return (jdef.CustomMSDeformableAttention(c, 4),
                tdef.CustomMSDeformableAttention(c, 4),
                (q, v, ref, shapes, pos), "cda")
    shapes = ((5, 7), (3, 4))
    cams = 3
    v = rng.randn(cams, b, sum(h * w for h, w in shapes), c).astype(
        np.float32)
    ref = rng.uniform(-0.1, 1.1, (cams, b, nq, 2, 2)).astype(np.float32)
    mask = rng.rand(cams, b, nq, 2) > 0.6
    mask[:, 0, 0] = False                 # a query no camera sees
    return (jdef.SpatialCrossAttention(c, cams, len(shapes), 4),
            tdef.SpatialCrossAttention(c, cams, len(shapes), 4),
            (q, v, ref, mask, shapes, pos), "sca")


def _load_attention(kind, port, params):
    sd = {}
    if kind == "sca":
        tw._deform_attn(sd, "m.deformable_attention",
                        params["deformable_attention"])
        tw._dense(sd, "m.output_proj", params["output_proj"])
    else:
        tw._deform_attn(sd, "m", params)
    port.load_state_dict({k[2:]: v for k, v in sd.items()})
    return port.eval()


def _as_torch(args):
    return tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in args)


def _as_jax(args):
    return tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in args)


@pytest.mark.parametrize("kind,chunked", [
    ("msda3d", False), ("tsa", False), ("tsa_no_prev", False),
    ("cda", False), ("sca", False), ("msda3d", True), ("tsa", True),
    ("sca", True)])
def test_attention_modules_match_jax(kind, chunked, monkeypatch):
    """Each module with spread sampling offsets; ``chunked`` sends the JAX
    MSDA3D (also inside SCA) and TSA through their chunked-dense paths
    (Dense projections inside the checkpointed chunk body), which the port
    equals."""
    if chunked:
        monkeypatch.setattr(jdef, "_Q_CHUNK_THRESHOLD", 8)
        monkeypatch.setattr(jdef, "_Q_CHUNK_TARGET", 10)
    rng = np.random.RandomState(11)
    jmod, tmod, args, key = _attention_case(kind, rng)
    params = _params(jmod, *_as_jax(args), seed=12)
    arrays = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]

    def apply(p, *arr):
        full = list(args)
        for i, a in zip(arrays, arr):
            full[i] = a
        return jmod.apply({"params": p}, *full)

    want = jax.jit(apply)(params, *(jnp.asarray(args[i]) for i in arrays))
    got = _load_attention(key, tmod, params)(*_as_torch(args))
    _check(got, want, **SAMPLER)


@pytest.mark.parametrize("stride,hw", [(1, (9, 11)), (2, (8, 12)),
                                       (2, (9, 13))])
def test_deform_conv_matches_jax_with_gradients(stride, hw):
    """DCNv2 with a random offset convolution (taps over pixels, some off
    the plane): flax SAME padding at stride 2 (even and odd sides) and its
    base grid at i s; the gradients of the input, the kernel and the offset
    convolution through K5b / K6's plain versions against JAX autodiff."""
    rng = np.random.RandomState(13)
    x = rng.randn(2, *hw, 6).astype(np.float32)
    jmod = jdef.DeformConv2d(5, kernel=3, stride=stride)
    params = _params(jmod, jnp.asarray(x), seed=14)
    params["conv_offset"]["kernel"] = params["conv_offset"]["kernel"] * 4

    def loss(p, xx):
        return jnp.sum(jnp.sin(jmod.apply({"params": p}, xx)))

    want = jax.jit(lambda p, xx: jmod.apply({"params": p}, xx))(
        params, jnp.asarray(x))
    g_p, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params,
                                                       jnp.asarray(x))
    tmod = tdef.DeformConv2d(6, 5, 3, stride=stride)
    k = np.asarray(params["kernel"])
    sd = {"weight": _t(k.reshape(3, 3, 6, 5).transpose(3, 2, 0, 1))}
    tw._conv(sd, "conv_offset", params["conv_offset"])
    tmod.load_state_dict(sd)
    xt = torch.from_numpy(to_nchw(x)).requires_grad_(True)
    got = tmod(xt)
    _check(got.permute(0, 2, 3, 1), want, **NET)
    torch.sin(got).sum().backward()
    assert _rel(xt.grad.permute(0, 2, 3, 1), g_x) < 1e-4
    assert _rel(tmod.weight.grad.permute(2, 3, 1, 0).reshape(9, 6, 5),
                g_p["kernel"]) < 1e-4
    assert _rel(tmod.conv_offset.weight.grad.permute(2, 3, 1, 0),
                g_p["conv_offset"]["kernel"]) < 1e-4
    assert _rel(tmod.conv_offset.bias.grad, g_p["conv_offset"]["bias"]) < 1e-4


@pytest.mark.parametrize("rotate", [False, True])
def test_shift_prev_bev_matches_jax(rotate):
    rng = np.random.RandomState(15)
    prev = rng.randn(2, 6 * 7, 5).astype(np.float32)
    delta = rng.uniform(-0.3, 0.3, (2, 2)).astype(np.float32)
    rot = rng.uniform(-20, 20, (2,)).astype(np.float32) if rotate else None
    want = jax.jit(lambda p, d, r: jbev.shift_prev_bev(p, 6, 7, d, r))(
        jnp.asarray(prev), jnp.asarray(delta),
        None if rot is None else jnp.asarray(rot))
    got = tbev.shift_prev_bev(_t(prev), 6, 7, _t(delta),
                              None if rot is None else _t(rot))
    _check(got, want, **SAMPLER)


def test_pillar_projection_matches_jax_on_the_surround_rig():
    pc = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    l2i = tut.surround_lidar2img(90, 160)
    pts = jax.jit(lambda: jbev.bev_pillar_points(6, 6, 4, pc))()
    _check(tbev.bev_pillar_points(6, 6, 4, pc), pts, rtol=1e-6)
    want_xy, want_mask = jax.jit(lambda p, m: jbev.project_points_to_cams(
        p, m, 90, 160))(pts, jnp.asarray(l2i.numpy()))
    xy, mask = tbev.project_points_to_cams(tbev.bev_pillar_points(
        6, 6, 4, pc), l2i, 90, 160)
    np.testing.assert_array_equal(_np(mask), np.asarray(want_mask))
    # Points behind a camera divide by the clamped depth 1e-5: values of
    # 1e6, whose last bits follow the order of the division.
    _check(xy, want_xy, rtol=1e-4, atol=1e-5)
    assert float(mask.any(-1).any(0).float().mean()) > 0.9


# ----------------------------------------------------------------------
# Track runtime
# ----------------------------------------------------------------------

def _jax_tracks(n, c, nc, mem, rng):
    t = jtr.empty_tracks(n, c, nc, mem)
    return t.replace(
        ref_pts=jnp.asarray(rng.rand(n, 3), jnp.float32),
        query=jnp.asarray(rng.randn(n, 2 * c), jnp.float32),
        output_embedding=jnp.asarray(rng.randn(n, c), jnp.float32),
        obj_idxes=jnp.asarray(rng.randint(-1, 3, n), jnp.int32),
        scores=jnp.asarray(rng.rand(n), jnp.float32),
        track_scores=jnp.asarray(rng.rand(n), jnp.float32),
        pred_boxes=jnp.asarray(np.concatenate(
            [rng.uniform(-3, 3, (n, 2)), rng.uniform(0, 1, (n, 2)),
             rng.randn(n, 2), rng.randn(n, 4)], -1), jnp.float32),
        disappear_time=jnp.asarray(rng.randint(0, 3, n), jnp.int32),
        mem_bank=jnp.asarray(rng.randn(n, mem, c), jnp.float32),
        mem_valid=jnp.asarray(rng.rand(n, mem) > 0.5),
        save_period=jnp.asarray(rng.randint(0, 3, n), jnp.int32))


def _to_port(tracks) -> ttr.TrackInstances:
    return ttr.TrackInstances(**{
        f: torch.from_numpy(np.array(getattr(tracks, f)))
        for f in ttr.TrackInstances.__dataclass_fields__})


def _check_tracks(got: ttr.TrackInstances, want, **tol):
    for f in ttr.TrackInstances.__dataclass_fields__:
        a, b = _np(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        if a.dtype in (np.int32, np.bool_):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, err_msg=f, **tol)


@pytest.mark.parametrize("dedup", [None, 0.1])
def test_tracker_update_and_velocity_match_jax(dedup):
    rng = np.random.RandomState(16)
    tracks = _jax_tracks(14, 8, 3, 2, rng)
    scores = rng.rand(14).astype(np.float32)
    # Away from the thresholds (0.35, 0.4): discrete decisions compared.
    scores[np.abs(scores - 0.375) < 0.05] = 0.9
    tracks = tracks.replace(track_scores=jnp.asarray(scores))
    want, want_id = jax.jit(lambda t, i: jtr.tracker_update(
        t, 0.4, 0.35, 2, i, dedup))(tracks, jnp.asarray(5, jnp.int32))
    got, got_id = ttr.tracker_update(_to_port(tracks), 0.4, 0.35, 2,
                                     torch.tensor(5, dtype=torch.int32), dedup)
    _check_tracks(got, want)
    assert int(got_id) == int(want_id) and got_id.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(ttr.active_mask(got)), np.asarray(jax.jit(jtr.active_mask)(want)))
    vel = rng.randn(14, 2).astype(np.float32)
    pc = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    _check(ttr.velocity_update_reference_points(got, _t(vel), 0.5,
                                                pc).ref_pts,
           jax.jit(lambda t, v: jtr.velocity_update_reference_points(
               t, v, 0.5, pc))(want, jnp.asarray(vel)).ref_pts, rtol=1e-6)


def test_memory_bank_and_qim_match_jax_with_fully_masked_rows():
    """Slots without a valid history entry and a QIM update mask of no
    slot make fully masked attention rows: flax fills their logits with the
    most negative float, a uniform softmax, discarded by the ``where``;
    the port does the same, and its gradients stay finite (a -inf fill
    gives NaN there)."""
    rng = np.random.RandomState(17)
    tracks = _jax_tracks(10, 16, 3, 3, rng)
    valid = np.asarray(tracks.mem_valid).copy()
    valid[:3] = False                       # no history at all
    tracks = tracks.replace(mem_valid=jnp.asarray(valid))
    mb = jtr.MemoryBank(embed_dims=16, mem_len=3, save_thresh=0.3)
    p_mb = _params(mb, tracks, seed=18)
    want = jax.jit(lambda p, t: mb.apply({"params": p}, t))(p_mb, tracks)
    port_mb = ttr.MemoryBank(16, 3, save_thresh=0.3)
    sd = {}
    tw._dense(sd, "save_proj", p_mb["save_proj"])
    tw._mha(sd, "temporal_attn", p_mb["temporal_attn"])
    for n in ("temporal_fc1", "temporal_fc2"):
        tw._dense(sd, n, p_mb[n])
    for n in ("temporal_norm1", "temporal_norm2"):
        tw._norm(sd, n, p_mb[n])
    port_mb.load_state_dict(sd)
    got = port_mb(_to_port(tracks))
    _check_tracks(got, want, atol=2e-5, rtol=1e-5)

    qim = jtr.QueryInteractionModule(embed_dims=16, update_query_pos=True)
    p_q = _params(qim, want, seed=19)
    port_q = ttr.QueryInteractionModule(16, update_query_pos=True)
    sd = {}
    tw._mha(sd, "self_attn", p_q["MultiHeadDotProductAttention_0"])
    for f, n in (("Dense_0", "linear1"), ("Dense_1", "linear2"),
                 ("pos_ffn1", "linear_pos1"), ("pos_ffn2", "linear_pos2"),
                 ("feat_ffn1", "linear_feat1"),
                 ("feat_ffn2", "linear_feat2")):
        tw._dense(sd, n, p_q[f])
    for f, n in (("LayerNorm_0", "norm1"), ("LayerNorm_1", "norm2"),
                 ("pos_norm", "norm_pos"), ("feat_norm", "norm_feat")):
        tw._norm(sd, n, p_q[f])
    port_q.load_state_dict(sd)
    for mask in (None, np.zeros(10, bool)):
        w = jax.jit(lambda p, t, m: qim.apply({"params": p}, t, m))(
            p_q, want, None if mask is None else jnp.asarray(mask))
        g = port_q(got, None if mask is None else torch.from_numpy(mask))
        _check(g.query, w.query, atol=2e-5, rtol=1e-5)

    bank = torch.from_numpy(np.array(tracks.mem_bank)).requires_grad_(True)
    out = port_mb(_to_port(tracks).replace(mem_bank=bank))
    port_q(out, torch.zeros(10, dtype=torch.bool)).query.sum().backward()
    assert torch.isfinite(bank.grad).all()


# ----------------------------------------------------------------------
# The backbone and the whole model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("style,norm,hw", [("caffe", "affine", (64, 96)),
                                           ("pytorch", "gn", (72, 104))])
def test_resnet_fpn_matches_jax(style, norm, hw):
    """Both styles and norms; at 72x104 the levels are 9x13, 5x7 and 3x4,
    so the top-down resize is not a doubling: ``jax.image.resize``
    "nearest" is torch's ``nearest-exact``, and the stride-2 DCN and stem
    windows fall on odd sides."""
    x = np.random.RandomState(20).rand(1, *hw, 3).astype(np.float32)
    jnet = jua.ResNetFPN(stage_blocks=BLOCKS, embed_dims=32, style=style,
                         norm=norm)
    params = _params(jnet, jnp.asarray(x), seed=21)
    want = jax.jit(lambda p, xx: jnet.apply({"params": p}, xx))(
        params, jnp.asarray(x))
    sd = {}
    tw._uniad_backbone(sd, params, BLOCKS, (False, False, True, True))
    net = tua.ResNetFPN(BLOCKS, 32, style=style, norm=norm).eval()
    net.load_state_dict(sd)
    with torch.no_grad():
        got = net(torch.from_numpy(to_nchw(x)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _check(g.permute(0, 2, 3, 1), w, **NET)


def _jax_state(c=32, n=12, nc=3, mem=2, bev=16):
    return jua.TrackState(prev_bev=jnp.zeros((1, bev, c)),
                          tracks=jtr.empty_tracks(n, c, nc, mem),
                          next_obj_id=jnp.zeros((), jnp.int32),
                          timestamp=jnp.zeros(()),
                          has_prev=jnp.zeros((), bool))


FRAME_HW = (64, 64)


@pytest.fixture(scope="module")
def frame_inputs():
    h, w = FRAME_HW
    imgs = np.random.RandomState(22).rand(2, 1, h, w, 3).astype(np.float32)
    l2i = tut.surround_lidar2img(h, w, yaws=(0.0, 180.0)).numpy()
    return imgs, l2i


_JAX_FRAMES = {}


def _jax_frames(norm, params, imgs, l2i):
    """Two chained JAX frames (the second with an ego shift and rotation),
    one jitted frame function for each backbone norm."""
    style = "caffe" if norm == "affine" else "pytorch"
    if norm not in _JAX_FRAMES:
        model = jua.UniADTrack(**SMALL, backbone_style=style,
                               backbone_norm=norm)

        def frame(p, st, ts, shift, rot):
            return model.apply({"params": p}, jnp.asarray(imgs),
                               jnp.asarray(l2i), st, timestamp=ts,
                               ego_shift=shift, ego_rotation_deg=rot)
        _JAX_FRAMES[norm] = (model, jax.jit(frame))
    model, frame = _JAX_FRAMES[norm]
    st0 = jax.jit(lambda p: model.apply({"params": p},
                                        method=model.init_state))(params)
    st1, _ = frame(params, st0, 0.5, None, None)
    st2, res = frame(params, st1, 1.0, jnp.asarray([[0.1, -0.05]]),
                     jnp.asarray([7.0]))
    return st1, st2, res


def _port_frames(model, imgs, l2i):
    timgs = torch.from_numpy(imgs).permute(0, 1, 4, 2, 3)
    tl2i = torch.from_numpy(l2i)
    with torch.no_grad():
        st1, _ = model(timgs, tl2i, model.init_state(), timestamp=0.5)
        st2, res = model(timgs, tl2i, st1, timestamp=1.0,
                         ego_shift=torch.tensor([[0.1, -0.05]]),
                         ego_rotation_deg=torch.tensor([7.0]))
    return st1, st2, res


def _compare_frames(got, want):
    (g1, g2, gr), (w1, w2, wr) = got, want
    scores = np.concatenate([np.asarray(w1.tracks.track_scores),
                             np.asarray(w2.tracks.track_scores)])
    assert np.abs(scores - 0.4).min() > 1e-3
    assert np.abs(scores - 0.35).min() > 1e-3
    for g, w in ((g1, w1), (g2, w2)):
        _check(g.prev_bev, w.prev_bev, **NET)
        boxes_g, boxes_w = g.tracks.pred_boxes, w.tracks.pred_boxes
        assert _rel(boxes_g, boxes_w) < 1e-4
        _check_tracks(g.tracks.replace(pred_boxes=torch.from_numpy(
            np.array(boxes_w))), w.tracks, **NET)
        assert int(g.next_obj_id) == int(w.next_obj_id)
    for k in ("query_idx", "labels", "valid", "obj_idxes"):
        np.testing.assert_array_equal(_np(gr[k]), np.asarray(wr[k]),
                                      err_msg=k)
    _check(gr["scores"], wr["scores"], **NET)
    assert _rel(gr["bboxes"], wr["bboxes"]) < 1e-4


@pytest.mark.parametrize("norm", ["affine", "gn"])
def test_two_chained_frames_match_jax(norm, frame_inputs):
    """``UniADTrack`` for two chained frames on a two-camera rig that sees
    the BEV (the caffe R50-style backbone with frozen BN, or the pytorch
    one with GroupNorm): the carried state, every track field, the ids and
    the decoded detections."""
    imgs, l2i = frame_inputs
    style = "caffe" if norm == "affine" else "pytorch"
    jm = jua.UniADTrack(**SMALL, backbone_style=style, backbone_norm=norm)
    params = _params(jm, jnp.asarray(imgs), jnp.asarray(l2i), _jax_state(),
                     seed=23)
    want = _jax_frames(norm, params, imgs, l2i)
    model = tua.UniADTrack(**SMALL, backbone_style=style,
                           backbone_norm=norm).eval()
    model.load_state_dict(tw.uniad_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), BLOCKS))
    got = _port_frames(model, imgs, l2i)
    _compare_frames(got, want)
    assert int((got[1].tracks.obj_idxes >= 0).sum()) > 0


def test_weight_round_trip_through_convert_uniad(frame_inputs):
    """The port's seeded weights (spread offsets) -> its state_dict ->
    ``convert_uniad`` -> JAX params: the same two frames on each side."""
    imgs, l2i = frame_inputs
    model = tua.UniADTrack(**SMALL, backbone_style="caffe",
                           backbone_norm="affine")
    gen = torch.Generator().manual_seed(24)
    tua.init_weights(model, gen)
    model.eval()
    timgs = torch.from_numpy(imgs).permute(0, 1, 4, 2, 3)
    tua.spread_offsets(model, lambda: model(
        timgs, torch.from_numpy(l2i), model.init_state()), gen)
    got = _port_frames(model, imgs, l2i)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = convert_uniad(sd, blocks=BLOCKS, encoder_layers=1,
                           decoder_layers=2)
    want = _jax_frames("affine", params, imgs, l2i)
    _compare_frames(got, want)


def test_a_float64_evaluation_stays_float64(frame_inputs):
    """``dtype=torch.float64`` with float64 weights, inputs and state: every
    step that JAX casts to float32 stays float64 (the CPU sampler takes its
    plain version), the carry stays float64, and the float32 run is within
    float32 rounding of it (2e-5 by norm; measured up to 2.3e-6)."""
    imgs, l2i = frame_inputs
    model = tua.UniADTrack(**SMALL)
    gen = torch.Generator().manual_seed(26)
    tua.init_weights(model, gen)
    model.eval()
    timgs = torch.from_numpy(imgs).permute(0, 1, 4, 2, 3)
    tua.spread_offsets(model, lambda: model(
        timgs, torch.from_numpy(l2i), model.init_state()), gen)
    want = _port_frames(model, imgs, l2i)
    wide = tua.UniADTrack(**SMALL, dtype=torch.float64).double().eval()
    wide.load_state_dict(model.state_dict())
    state = wide.init_state()
    f64 = lambda v: v.double() if v.is_floating_point() else v
    state = tua.TrackState(
        prev_bev=f64(state.prev_bev), tracks=ttr.TrackInstances(**{
            k: f64(v) for k, v in state.tracks.tensors().items()}),
        next_obj_id=state.next_obj_id, timestamp=f64(state.timestamp),
        has_prev=state.has_prev)
    timgs, tl2i = timgs.double(), torch.from_numpy(l2i).double()
    with torch.no_grad():
        st1, _ = wide(timgs, tl2i, state, timestamp=0.5)
        st2, _ = wide(timgs, tl2i, st1, timestamp=1.0,
                      ego_shift=torch.tensor([[0.1, -0.05]]).double(),
                      ego_rotation_deg=torch.tensor([7.0]).double())
    for got, w in ((st1, want[0]), (st2, want[1])):
        for t in (got.prev_bev, got.tracks.pred_logits, got.tracks.pred_boxes,
                  got.tracks.mem_bank, got.tracks.query):
            assert t.dtype == torch.float64
        for a, b in ((w.prev_bev, got.prev_bev),
                     (w.tracks.pred_logits, got.tracks.pred_logits),
                     (w.tracks.pred_boxes, got.tracks.pred_boxes)):
            assert _rel(a.double(), b) < 2e-5


def test_first_frame_attends_a_zero_previous_bev(frame_inputs):
    """The first frame hands temporal self-attention ``0 * prev_bev``, not
    None: its value is zeros, not the current BEV."""
    imgs, l2i = frame_inputs
    model = tua.UniADTrack(**SMALL)
    tua.init_weights(model, torch.Generator().manual_seed(25))
    seen = []
    tsa = model.pts_bbox_head.transformer.encoder.layers[0].attentions[0]
    real = tsa.forward
    tsa.forward = lambda q, prev, *a, **k: (seen.append(prev),
                                            real(q, prev, *a, **k))[1]
    with torch.no_grad():
        model(torch.from_numpy(imgs).permute(0, 1, 4, 2, 3),
              torch.from_numpy(l2i), model.init_state())
    assert seen[0] is not None and float(seen[0].abs().max()) == 0.0


def test_carried_state_dtypes_stable_bf16(frame_inputs):
    """tests/test_uniad.py:310 on the port: a bf16 model's chained frames
    keep every carried field's dtype."""
    imgs, l2i = frame_inputs
    model = tua.UniADTrack(**SMALL, dtype=torch.bfloat16)
    tua.init_weights(model, torch.Generator().manual_seed(26))
    timgs = torch.from_numpy(imgs).permute(0, 1, 4, 2, 3)
    st0 = model.init_state()
    with torch.no_grad():
        st1, _ = model(timgs, torch.from_numpy(l2i), st0)
        st2, res = model(timgs, torch.from_numpy(l2i), st1,
                         ego_shift=torch.tensor([[0.1, 0.0]]))
    for st in (st1, st2):
        for k, v in st0.tracks.tensors().items():
            assert st.tracks.tensors()[k].dtype == v.dtype, k
        for k in ("prev_bev", "next_obj_id", "timestamp", "has_prev"):
            assert getattr(st, k).dtype == getattr(st0, k).dtype, k
    assert torch.isfinite(res["scores"]).all()


def test_simple_test_track_chains_frames(frame_inputs):
    """``simple_test_track`` over a clip is the frames chained by hand from
    a fresh state, half a second apart."""
    imgs, l2i = frame_inputs
    model = tua.UniADTrack(**SMALL)
    tua.init_weights(model, torch.Generator().manual_seed(27))
    model.eval()
    timgs = torch.from_numpy(imgs).permute(0, 1, 4, 2, 3)
    seq, tl2i = torch.stack([timgs, timgs.flip(-1)]), torch.from_numpy(l2i)
    with torch.no_grad():
        state, results = model.simple_test_track(seq, tl2i)
        st = model.init_state()
        for t in range(2):
            st, res = model(seq[t], tl2i, st, timestamp=0.5 * t)
    assert len(results) == 2
    assert torch.equal(state.prev_bev, st.prev_bev)
    assert torch.equal(state.tracks.obj_idxes, st.tracks.obj_idxes)
    assert torch.equal(results[-1]["scores"], res["scores"])
    assert float(state.timestamp) == 0.5
