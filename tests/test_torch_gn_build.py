"""The plain version of the dense-SE3 Gauss-Newton build (K8), which CPU
tensors take, against the JAX package on the same inputs, made from a seed
with numpy: against the Pallas kernel ``sndepth_tpu.kernels.gn_build
.gn_build_hg`` (interpret mode on the CPU) and against the blocked XLA
build ``sndepth_tpu.models.raft3d._hg_xla``; ``gauss_newton_step`` against
JAX's; gradients against ``jax.grad`` of ``_hg_xla``; the plain version of
the backward (K8b) against the Pallas backward kernels
``gn_build_hg_bwd`` (interpret mode) and against ``jax.vjp`` of ``_hg_xla``;
and the dispatch rules of the wrappers.

Tolerances. H and g: each entry is a float32 sum over up to (2r+1)^2 pairs,
taken pair by pair in the Pallas kernel, as a Gram product in ``_hg_xla``
and as blocked contractions here, and H spans orders of magnitude (fx^2
between a translation and a rotation column), so an entry is held to 2e-5 of
its own size plus 2e-5 of the mean size of its entry position over the
pixels (the JAX package holds its two versions to 2e-4 + 2e-4 relative).
``gauss_newton_step``: atol 2e-5 + rtol 1e-4 on the updated field.
Gradients: rtol 5e-3 + atol 5e-3 of the largest entry, as the JAX package
holds its backward kernels to the XLA gradients. The plain backward on given
cotangents: each of the eight outputs to 1e-4 of an entry plus 1e-4 of the
output's mean size (float32 sums of up to 120 signed pair adjoints taken in
three different orders). Every output and gradient is asserted finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sndepth_tpu.kernels.gn_build import gn_build_hg as jax_kernel
from sndepth_tpu.kernels.gn_build import gn_build_hg_bwd as jax_kernel_bwd
from sndepth_tpu.models import raft3d as jraft
from sndepth_tpu.ops import se3 as jse3
from sndepth_tpu_torch.kernels import gn_build as K8
from sndepth_tpu_torch.models import raft3d as traft
from sndepth_tpu_torch.utils import tracing
from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield

DIFF = (0, 1, 2, 3, 6, 7, 8, 9)    # rot trans x sq X tgt wgt intrinsics


def _inputs(seed=0, b=1, h=6, w=9, emb=32):
    rng = np.random.RandomState(seed)
    n = h * w
    rot = (np.eye(3)[None, None]
           + 0.05 * rng.randn(b, n, 3, 3)).astype(np.float32)
    trans = rng.randn(b, n, 3).astype(np.float32) * 0.1
    trans[..., 2] += 2.0
    x = rng.randn(b, n, emb).astype(np.float32) * 0.3
    sq = np.sum(x * x, -1)
    gy = np.repeat(np.arange(h), w).astype(np.int32)
    gx = np.tile(np.arange(w), h).astype(np.int32)
    X = rng.rand(b, n, 3).astype(np.float32)
    X[..., 2] += 1.0
    tgt = rng.randn(b, n, 3).astype(np.float32)
    wgt = rng.rand(b, n, 3).astype(np.float32)
    intr4 = np.tile(np.array([[20.0, 21.0, 4.0, 3.0]], np.float32), (b, 1))
    intr4[-1] += 0.5 * (b - 1)
    return rot, trans, x, sq, gy, gx, X, tgt, wgt, intr4


def _torch(args):
    return tuple(torch.from_numpy(a) for a in args)


def _jax_f32_grid(args):
    """The Pallas entry takes the grid positions as float32."""
    a = [jnp.asarray(v) for v in args]
    a[4], a[5] = a[4].astype(jnp.float32), a[5].astype(jnp.float32)
    return a


def _close(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    scale = np.abs(want).mean(axis=(0, 1), keepdims=True)
    tol = 2e-5 * np.abs(want) + 2e-5 * scale
    worst = (np.abs(got - want) / np.maximum(tol, 1e-30)).max()
    assert worst <= 1.0, f"off by {worst} x the tolerance"


# n = 54, 35 and 120: none a multiple of 128, the first two not of 8.
CASES = [(0, 1, 6, 9, 3), (1, 2, 5, 7, 3), (2, 2, 6, 9, 32), (3, 1, 8, 15, 2)]


@pytest.mark.parametrize("seed,b,h,w,radius", CASES)
def test_plain_build_matches_the_pallas_kernel(seed, b, h, w, radius):
    args = _inputs(seed, b, h, w)
    H, g = K8.gn_build_hg(*_torch(args), radius)
    Hj, gj = jax_kernel(*_jax_f32_grid(args), radius)
    _close(H, Hj)
    _close(g, gj)
    assert torch.equal(H, H.transpose(-1, -2))
    assert H.shape == (b, h * w, 6, 6) and g.shape == (b, h * w, 6)


@pytest.mark.parametrize("seed,b,h,w,radius", CASES)
def test_plain_build_matches_the_xla_build(seed, b, h, w, radius):
    args = _inputs(seed, b, h, w)
    H, g = K8.gn_build_hg_reference(*_torch(args), radius)
    Hj, gj = jraft._hg_xla(*map(jnp.asarray, args), radius, 16)
    _close(H, Hj)
    _close(g, gj)
    assert torch.equal(H, H.transpose(-1, -2))


def test_blocked_accumulation_equals_the_single_shot(monkeypatch):
    """Beyond 2048 pixels the plain version sums the j axis in blocks of
    1024; here the thresholds are lowered so that a ragged last block runs
    at a small size."""
    args = _torch(_inputs(4, 2, 7, 9))
    H1, g1 = K8.gn_build_hg_reference(*args, 3)
    monkeypatch.setattr(K8, "_SINGLE_SHOT_MAX", 32)
    monkeypatch.setattr(K8, "_BLOCK", 20)      # 63 = 3 * 20 + 3
    H2, g2 = K8.gn_build_hg_reference(*args, 3)
    _close(H2, H1.numpy())
    _close(g2, g1.numpy())
    Hj, gj = jraft._hg_xla(*(jnp.asarray(a.numpy()) for a in args), 3, 20)
    _close(H2, Hj)
    _close(g2, gj)


def test_radius_zero_leaves_each_pixel_its_own_pair():
    """With radius 0 only j = i counts: each pixel's system equals the
    build of that pixel alone on a 1 x 1 grid (to float32 rounding of the
    same products, rtol 1e-6)."""
    args = list(_inputs(5, 1, 4, 5))
    H, g = K8.gn_build_hg_reference(*_torch(args), 0)
    for i in (0, 7, 19):
        one = [a[:, i:i + 1] if a.ndim > 1 and a.shape[1] == 20 else a
               for a in args]
        one[4], one[5] = args[4][i:i + 1], args[5][i:i + 1]
        Hi, gi = K8.gn_build_hg_reference(*_torch(one), 0)
        torch.testing.assert_close(H[:, i], Hi[:, 0], rtol=1e-6, atol=0)
        torch.testing.assert_close(g[:, i], gi[:, 0], rtol=1e-6, atol=0)


def zero_depth_case():
    """Inputs in which one pair (i = 0, j = 19) lies outside radius 1 and
    has a transformed depth of exactly 0; every other pair's is 0.5 or
    more."""
    args = list(_inputs(6, 1, 4, 5))
    args[0][:] = np.eye(3, dtype=np.float32)
    args[6][..., 2] += 1.0                      # depths in [2, 3)
    args[6][0, 19, 2] = 1.5
    args[1][0, 0, 2] = -1.5                     # P_z(0, 19) = 1.5 - 1.5
    return args


def test_a_masked_pair_at_zero_depth_follows_jax():
    """There the weight is exactly 0 but the Jacobian is infinite: the JAX
    build forms 0 * inf = NaN in pixel 0's sums, and so does the plain
    version, which multiplies by the mask as it does. (The CUDA kernel
    skips the pair and stays finite: the card check holds that.) Every
    other pixel is finite and equal."""
    args = zero_depth_case()
    H, g = K8.gn_build_hg_reference(*_torch(args), 1)
    Hj, gj = jraft._hg_xla(*map(jnp.asarray, args), 1, 16)
    assert not np.isfinite(np.asarray(Hj)[0, 0]).all()
    assert not torch.isfinite(H[0, 0]).all()
    _close(H[:, 1:], np.asarray(Hj)[:, 1:])
    _close(g[:, 1:], np.asarray(gj)[:, 1:])


def test_gauss_newton_step_matches_jax():
    rng = np.random.RandomState(7)
    b, h, w = 2, 6, 8
    tangent = (rng.randn(b, h, w, 6) * 0.05).astype(np.float32)
    Ts = np.array(jse3.exp(jnp.asarray(tangent)))
    ae = rng.randn(b, h, w, 32).astype(np.float32)
    depth = (1.5 + rng.rand(b, h, w)).astype(np.float32)
    intr = np.array([[20.0, 21.0, 4.0, 3.0], [19.0, 20.0, 4.2, 2.9]],
                    np.float32)
    weight = rng.rand(b, h, w, 3).astype(np.float32)
    coords, _ = jraft.pops.projective_transform(
        jnp.asarray(Ts), jnp.asarray(depth), jnp.asarray(intr))
    target = (np.asarray(coords)
              + 0.3 * rng.randn(b, h, w, 3).astype(np.float32) * [1, 1, 0.01]
              ).astype(np.float32)
    for radius in (2, 32):
        got = traft.gauss_newton_step(*_torch(
            (Ts, ae, target, weight, depth, intr)), radius=radius)
        want = jraft.gauss_newton_step(*map(jnp.asarray, (
            Ts, ae, target, weight, depth, intr)), radius=radius)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=1e-4)
        assert float((got - torch.from_numpy(Ts)).abs().max()) > 1e-3


def _loss_grads(args, radius, build):
    t = list(_torch(args))
    for i in DIFF:
        t[i] = t[i].clone().requires_grad_(True)
    H, g = build(*t, radius)
    (torch.sin(H).sum() + (g * g).sum()).backward()
    return [t[i].grad for i in DIFF]


@pytest.mark.parametrize("radius", [3, 100])
def test_plain_build_gradients_match_jax_grad_of_the_xla_build(radius):
    """radius 3 masks most pairs (their gradients must be finite zeros, not
    NaN), radius 100 none."""
    args = _inputs(1)

    def loss(*diff):
        full = list(map(jnp.asarray, args))
        for i, d in zip(DIFF, diff):
            full[i] = d
        H, g = jraft._hg_xla(*full, radius, 16)
        return jnp.sum(jnp.sin(H)) + jnp.sum(g * g)

    want = jax.grad(loss, argnums=tuple(range(8)))(
        *(jnp.asarray(args[i]) for i in DIFF))
    got = _loss_grads(args, radius, K8.gn_build_hg)
    for i, (a, b) in zip(DIFF, zip(got, want)):
        b = np.asarray(b)
        assert torch.isfinite(a).all(), f"arg {i} gradient not finite"
        assert np.isfinite(b).all()
        np.testing.assert_allclose(a.numpy(), b, rtol=5e-3,
                                   atol=5e-3 * max(1.0, np.abs(b).max()),
                                   err_msg=f"arg {i}")


def test_gradients_are_finite_where_a_masked_pair_has_zero_weight():
    """Masked pairs and exactly-zero confidences together: a square root of
    the weight would have an infinite derivative there."""
    args = list(_inputs(2))
    args[8] = args[8].copy()
    args[8][:, ::3] = 0.0
    for a in _loss_grads(args, 2, K8.gn_build_hg_reference):
        assert torch.isfinite(a).all()


def test_the_16_wide_embedding_takes_the_plain_build(monkeypatch):
    """The bilaplacian variant's embedding is 16 wide: the step must not
    reach the kernel wrapper, on any device, as the JAX package keeps it on
    its XLA build."""
    calls = {"wrapper": 0, "plain": 0}
    plain = K8.gn_build_hg_reference

    def wrapper(*a):
        calls["wrapper"] += 1
        return plain(*a)

    def counted(*a):
        calls["plain"] += 1
        return plain(*a)

    monkeypatch.setattr(traft, "gn_build_hg", wrapper)
    monkeypatch.setattr(traft, "gn_build_hg_reference", counted)
    rng = np.random.RandomState(8)
    b, h, w = 1, 5, 6
    Ts = torch.from_numpy(np.asarray(jse3.identity((b, h, w))).copy())
    tgt = torch.from_numpy(rng.randn(b, h, w, 3).astype(np.float32))
    wgt = torch.from_numpy(rng.rand(b, h, w, 3).astype(np.float32))
    depth = torch.full((b, h, w), 2.0)
    K = torch.tensor([[20.0, 21.0, 4.0, 3.0]])
    for width, want in ((16, {"wrapper": 0, "plain": 1}),
                        (32, {"wrapper": 1, "plain": 1})):
        ae = torch.from_numpy(rng.randn(b, h, w, width).astype(np.float32))
        out = traft.gauss_newton_step(Ts, ae, tgt, wgt, depth, K, radius=3)
        assert torch.isfinite(out).all() and calls == want
    # The 16-wide plain build against JAX's.
    args = _inputs(9, emb=16)
    H, g = K8.gn_build_hg_reference(*_torch(args), 3)
    Hj, gj = jraft._hg_xla(*map(jnp.asarray, args), 3, 16)
    _close(H, Hj)
    _close(g, gj)
    with pytest.raises(ValueError, match="32-wide"):
        K8._launch(*_torch(args), 3)


def test_a_launch_without_a_card_raises_and_counts_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    before = tracing.counts()["K8"]
    with pytest.raises((RuntimeError, OSError)):
        K8._launch(*_torch(_inputs()), 3)
    H, _ = K8.gn_build_hg(*_torch(_inputs()), 3)      # CPU: plain version
    assert H.shape == (1, 54, 6, 6)
    assert tracing.counts()["K8"] == before
    meta = tuple(a.to("meta") for a in _torch(_inputs()))
    with pytest.raises(ValueError, match="no gn_build kernel"):
        K8.gn_build_hg(*meta, 3)


BWD_NAMES = ("rot", "trans", "x", "sq", "X", "tgt", "wgt", "intrinsics")
BWD_CASES = [(3, 1), (3, 2), (100, 1), (100, 2)]     # radius, batch


def _cotangents(seed, b, n):
    rng = np.random.RandomState(100 + seed)
    return (rng.randn(b, n, 6, 6).astype(np.float32),
            rng.randn(b, n, 6).astype(np.float32))


def _bwd_close(got, want):
    assert len(got) == len(want) == 8
    for name, a, b in zip(BWD_NAMES, got, want):
        a, b = a.detach().numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        assert np.isfinite(a).all() and np.isfinite(b).all(), name
        tol = 1e-4 * np.abs(b) + 1e-4 * np.abs(b).mean()
        worst = (np.abs(a - b) / np.maximum(tol, 1e-30)).max()
        assert worst <= 1.0, f"d {name} off by {worst} x the tolerance"


@pytest.mark.parametrize("radius,b", BWD_CASES)
def test_plain_backward_matches_the_pallas_backward(radius, b):
    """radius 3 masks most pairs, radius 100 none."""
    args = _inputs(10 + b, b)
    ct_H, ct_g = _cotangents(radius + b, b, 54)
    got = K8.gn_build_hg_bwd_reference(*_torch(args), radius,
                                       torch.from_numpy(ct_H),
                                       torch.from_numpy(ct_g))
    want = jax_kernel_bwd(*_jax_f32_grid(args), radius, jnp.asarray(ct_H),
                          jnp.asarray(ct_g))
    _bwd_close(got, want)


@pytest.mark.parametrize("radius,b", BWD_CASES)
def test_plain_backward_matches_jax_vjp_of_the_xla_build(radius, b):
    args = _inputs(20 + b, b)
    ct_H, ct_g = _cotangents(radius + b + 7, b, 54)
    full = list(map(jnp.asarray, args))

    def build(*diff):
        a = list(full)
        for i, d in zip(DIFF, diff):
            a[i] = d
        H, g = jraft._hg_xla(*a, radius, 16)
        # The XLA build returns H as summed; the port mirrors the upper
        # triangle, as the kernels do.
        return jnp.triu(H) + jnp.swapaxes(jnp.triu(H, 1), -1, -2), g

    _, vjp = jax.vjp(build, *(full[i] for i in DIFF))
    want = vjp((jnp.asarray(ct_H), jnp.asarray(ct_g)))
    got = K8.gn_build_hg_bwd(*_torch(args), radius, torch.from_numpy(ct_H),
                             torch.from_numpy(ct_g))       # CPU: plain version
    _bwd_close(got, want)


WANT_SUBSETS = [(False, False, True, True, False, True, True, False),
                (True, False, False, False, False, False, False, True),
                (False,) * 7 + (True,), (False,) * 8]


@pytest.mark.parametrize("want", WANT_SUBSETS)
def test_the_backward_returns_only_the_gradients_asked_for(want):
    args = _torch(_inputs(30))
    ct_H, ct_g = map(torch.from_numpy, _cotangents(30, 1, 54))
    every = K8.gn_build_hg_bwd(*args, 3, ct_H, ct_g)
    some = K8.gn_build_hg_bwd(*args, 3, ct_H, ct_g, want)
    for w, a, b in zip(want, some, every):
        assert (a is not None) == w
        if w:
            assert torch.equal(a, b)


@pytest.mark.parametrize("want", WANT_SUBSETS[:2])
def test_the_autograd_function_asks_the_backward_for_what_is_needed(
        monkeypatch, want):
    """The CUDA path's ``torch.autograd.Function`` with its forward launch
    replaced by the plain version, so that it runs here: its backward hands
    ``needs_input_grad`` on, returns gradients of the inputs' type and shape
    for the inputs that want one, and they equal autograd through the plain
    build."""
    asked = []
    backward = K8.gn_build_hg_bwd

    def record(*a):
        asked.append(a[-1])
        return backward(*a)

    monkeypatch.setattr(K8, "_launch", K8.gn_build_hg_reference)
    monkeypatch.setattr(K8, "gn_build_hg_bwd", record)
    ct_H, ct_g = map(torch.from_numpy, _cotangents(31, 1, 54))
    grads = []
    for build in (K8._GNBuild.apply, K8.gn_build_hg_reference):
        t = list(_torch(_inputs(31)))
        for i, w in zip(DIFF, want):
            if w:
                t[i] = t[i].clone().requires_grad_(True)
        H, g = build(*t, 3)
        leaves = [t[i] for i, w in zip(DIFF, want) if w]
        grads.append(torch.autograd.grad([H, g], leaves, [ct_H, ct_g]))
        for leaf, grad in zip(leaves, grads[-1]):
            assert grad.dtype == leaf.dtype and grad.shape == leaf.shape
            assert torch.isfinite(grad).all()
    assert asked == [want]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_a_backward_launch_without_a_card_raises_and_counts_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = _torch(_inputs())
    ct_H, ct_g = map(torch.from_numpy, _cotangents(0, 1, 54))
    before = tracing.counts()["K8b"]
    for want in ((True,) * 8, WANT_SUBSETS[0]):
        with pytest.raises((RuntimeError, OSError), match="nvcc|cannot"):
            K8.gn_build_bwd(K8._kernel_inputs(*args), ct_H, ct_g, 3, want)
    assert tracing.counts()["K8b"] == before
    meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError, match="no gn_build kernel"):
        K8.gn_build_hg_bwd(*meta, 3, torch.zeros(1, 54, 6, 6, device="meta"),
                           torch.zeros(1, 54, 6, device="meta"))
    # The 16-wide embedding and float64 never reach a kernel.
    with pytest.raises(ValueError, match="32-wide"):
        K8._kernel_inputs(*_torch(_inputs(9, emb=16)))
    with pytest.raises(TypeError, match="float32"):
        K8._kernel_inputs(*(a.double() if a.is_floating_point() else a
                            for a in args))


def test_the_plain_backward_sums_over_blocks_of_j(monkeypatch):
    """Beyond 2048 pixels the plain backward takes the gradients block by
    block; here the thresholds are lowered so that a ragged last block runs
    at a small size, against the single shot."""
    args = _torch(_inputs(4, 2, 7, 9))
    ct_H, ct_g = map(torch.from_numpy, _cotangents(4, 2, 63))
    one = K8.gn_build_hg_bwd_reference(*args, 3, ct_H, ct_g)
    monkeypatch.setattr(K8, "_SINGLE_SHOT_MAX", 32)
    monkeypatch.setattr(K8, "_BLOCK", 20)      # 63 = 3 * 20 + 3
    blocked = K8.gn_build_hg_bwd_reference(*args, 3, ct_H, ct_g)
    _bwd_close(blocked, [t.numpy() for t in one])


def test_the_plain_backward_is_nan_only_at_a_masked_pair_at_zero_depth():
    """As in the forward: the plain backward, like the TPU kernels, forms
    0 * inf = NaN in what belongs to pixel i = 0 and pixel j = 19 of that
    pair and in the intrinsics (a sum over every pair); everything else is
    finite. (The CUDA kernels skip the pair and stay finite everywhere: the
    card check holds that.)"""
    args = _torch(zero_depth_case())
    ct_H, ct_g = map(torch.from_numpy, _cotangents(6, 1, 20))
    drot, dtrans, dx, dsq, dX, dtgt, dwgt, dintr = \
        K8.gn_build_hg_bwd_reference(*args, 1, ct_H, ct_g)
    assert not torch.isfinite(drot[0, 0]).all()
    assert not torch.isfinite(dintr).all()
    for t in (drot, dtrans):
        assert torch.isfinite(t[:, 1:]).all()
    keep = [k for k in range(20) if k not in (0, 19)]
    for t in (dx, dsq, dX, dtgt, dwgt):
        assert torch.isfinite(t[:, keep]).all()


def test_plain_version_calls_only_plain_versions(monkeypatch):
    def poisoned(*a, **k):
        raise AssertionError("the plain version reached a kernel wrapper")

    monkeypatch.setattr(K8, "gn_build_hg", poisoned)
    monkeypatch.setattr(K8, "_launch", poisoned)
    monkeypatch.setattr(K8, "_library", poisoned)
    for name in ("gn_build_hg_bwd", "gn_build_bwd", "_kernel_inputs"):
        monkeypatch.setattr(K8, name, poisoned)
    H, g = K8.gn_build_hg_reference(*_torch(_inputs()), 3)
    assert torch.isfinite(H).all() and torch.isfinite(g).all()
    ct_H, ct_g = map(torch.from_numpy, _cotangents(0, 1, 54))
    for grad in K8.gn_build_hg_bwd_reference(*_torch(_inputs()), 3, ct_H,
                                             ct_g):
        assert torch.isfinite(grad).all()


@pytest.mark.parametrize("bad", ["dtype", "shape", "grid", "mixed"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = list(_torch(_inputs()))
    if bad == "dtype":
        args[6] = args[6].double()
    elif bad == "shape":
        args[7] = args[7][:, :-1]
    elif bad == "grid":
        args[4] = args[4][:-1]
    else:
        args[9] = args[9].to("meta")
    with pytest.raises((TypeError, ValueError)):
        K8.gn_build_hg(*args, 3)


def _grid(h, w):
    return (torch.arange(h).repeat_interleave(w).float(),
            torch.arange(w).repeat(h).float())


# The training and frame grids (n = 832, 3328, 7332), a height that is not
# a multiple of the patch's 8 rows and a width not of its 4 columns, a grid
# stored column-major (gy is not row-major: the width found is 1) and one
# whose gy never changes (the width found is n).
OWNER_CASES = {"16x52": _grid(16, 52), "32x104": _grid(32, 104),
               "47x156": _grid(47, 156), "13x7": _grid(13, 7),
               "column_major_9x6": tuple(t.reshape(9, 6).t().reshape(-1)
                                         for t in _grid(9, 6)),
               "one_row_50": (torch.zeros(50), torch.arange(50.0)),
               "one_patch_8x4": _grid(8, 4), "one_pixel": _grid(1, 1)}


@pytest.mark.parametrize("case", sorted(OWNER_CASES))
def test_the_owner_map_of_the_backward_kernel_is_a_bijection(case):
    """The host mirror of the kernel's owner map: every pixel has exactly
    one owner slot, for any ``gy``; the kernel's sums do not depend on the
    map (the radius test reads gy and gx), only its speed does."""
    gy, gx = OWNER_CASES[case]
    pixels = K8.owner_pixels(gy)
    n = gy.shape[0]
    assert pixels.shape == (n,)
    assert torch.equal(pixels.sort().values, torch.arange(n))
    if case == "32x104":
        # The first warp owns rows 0-7 of columns 0-3, row-major.
        want = (torch.arange(8)[:, None] * 104 + torch.arange(4)).reshape(-1)
        assert torch.equal(pixels[:32], want)


@pytest.mark.parametrize("h,w,least", [(32, 104, 0.96), (47, 156, 0.90)])
def test_the_patch_map_keeps_running_lanes_in_the_radius(monkeypatch, h, w,
                                                         least):
    """At radius 32, of the lanes that run a pair, at least 96% (32x104)
    and 90% (47x156) are in the radius with a warp owning 8 x 4 pixels,
    against 66% with 32 pixels of a row."""
    gy, gx = _grid(h, w)
    assert K8.lane_share(gy, gx, 32) >= least
    monkeypatch.setattr(K8, "owner_pixels", lambda g: torch.arange(len(g)))
    assert 0.65 <= K8.lane_share(gy, gx, 32) <= 0.66


@pytest.mark.parametrize("h,w,least,row_lo,row_hi",
                         [(16, 52, 0.97, 0.85, 0.87)])
def test_the_patch_map_keeps_running_lanes_in_the_radius_at_a_small_frame(
        monkeypatch, h, w, least, row_lo, row_hi):
    """The forward kernel shares the map; at the 128x416 frame's grid and
    radius 32 at least 97% of the running lanes are in the radius, against
    85-87% with 32 pixels of a row."""
    gy, gx = _grid(h, w)
    assert K8.lane_share(gy, gx, 32) >= least
    monkeypatch.setattr(K8, "owner_pixels", lambda g: torch.arange(len(g)))
    assert row_lo <= K8.lane_share(gy, gx, 32) <= row_hi


@pytest.mark.parametrize("blocks,want", [(1, 8), (26, 8), (33, 8), (34, 4),
                                         (52, 4), (104, 2), (208, 1),
                                         (230, 1)])
def test_the_cluster_size_fills_two_blocks_on_each_sm(blocks, want):
    """26 blocks (1 x 832) become 208 in clusters of 8; a grid past 132 SMs
    of two blocks each is left as it is."""
    assert K8.cluster_size(blocks) == want
    assert blocks * want <= K8.SLOTS or want == 1


# Grids of the cluster split's mirror: the frame and training grids at
# radius 32, a column-major grid and a single row at radius 3.
CLUSTER_CASES = {"16x52": (_grid(16, 52), 32), "32x104": (_grid(32, 104), 32),
                 "47x156": (_grid(47, 156), 32),
                 "column_major_9x6": (OWNER_CASES["column_major_9x6"], 3),
                 "one_row_50": (OWNER_CASES["one_row_50"], 3)}


@pytest.mark.parametrize("clusters", ["kernel", "eight"])
@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_the_cluster_split_visits_each_owned_pixels_tiles_once(case,
                                                               clusters):
    """The host mirror of the forward kernel's split: for every group of 32
    owners, each tile in reach of one of its pixels goes to exactly one
    block of its cluster, and the blocks' counts differ by at most one; with
    the kernel's cluster size and with clusters of 8."""
    (gy, gx), radius = CLUSTER_CASES[case]
    n = gy.shape[0]
    groups = -(-n // K8.OWNERS)
    csize = K8.cluster_size(groups) if clusters == "kernel" else 8
    split = K8.cluster_tiles(gy, gx, radius, csize)
    pixels = K8.owner_pixels(gy)
    assert len(split) == groups
    for k0, ranks in zip(range(0, n, K8.OWNERS), split):
        assert len(ranks) == csize
        visited = [j0 for tiles in ranks for j0 in tiles]
        assert len(visited) == len(set(visited))
        own = pixels[k0:k0 + K8.OWNERS]
        near = (((gy[own, None] - gy[None]).abs() <= radius)
                & ((gx[own, None] - gx[None]).abs() <= radius)).any(0)
        need = {j0 for j0 in range(0, n, K8.TILE)
                if bool(near[j0:j0 + K8.TILE].any())}
        assert need <= set(visited)
        counts = [len(tiles) for tiles in ranks]
        assert max(counts) - min(counts) <= 1
