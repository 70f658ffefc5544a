"""The port's SE3 field operations against ``sndepth_tpu.ops.se3`` on the
same inputs, made from a seed with numpy.

Tolerances: values atol 1e-6 + rtol 1e-5 (the same closed forms in float32;
``atan2``, ``sin`` and ``cos`` may differ in the last bit between the two
libraries). Gradients atol 1e-5 + rtol 1e-4: they divide by the small
angles the Taylor branches guard. Every output and gradient is asserted
finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sndepth_tpu.ops import se3 as jse3
from sndepth_tpu_torch.ops import se3 as tse3
from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield

VAL = dict(atol=1e-6, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)


def _fields(seed=0, shape=(2, 3, 4)):
    """Two unit-quaternion SE3 fields, a tangent field and points."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        t = rng.randn(*shape, 3)
        q = rng.randn(*shape, 4)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        out.append(np.concatenate([t, q], -1).astype(np.float32))
    tangent = (rng.randn(*shape, 6) * 0.7).astype(np.float32)
    points = rng.randn(*shape, 3).astype(np.float32)
    return out[0], out[1], tangent, points


def _check(got: torch.Tensor, want, **tol):
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


UNARY = ("log", "inv", "matrix", "normalize")
BINARY = ("mul",)


@pytest.mark.parametrize("name", UNARY)
def test_unary_group_ops_match_jax(name):
    g1, g2, _, _ = _fields()
    for g in (g1, g2):
        _check(getattr(tse3, name)(torch.from_numpy(g)),
               getattr(jse3, name)(jnp.asarray(g)), **VAL)


def test_mul_act_and_quaternion_helpers_match_jax():
    g1, g2, _, p = _fields(1)
    t1, t2, tp = map(torch.from_numpy, (g1, g2, p))
    _check(tse3.mul(t1, t2), jse3.mul(jnp.asarray(g1), jnp.asarray(g2)), **VAL)
    _check(tse3.act(t1, tp), jse3.act(jnp.asarray(g1), jnp.asarray(p)), **VAL)
    q1, q2 = g1[..., 3:], g2[..., 3:]
    _check(tse3.quat_mul(t1[..., 3:], t2[..., 3:]),
           jse3.quat_mul(jnp.asarray(q1), jnp.asarray(q2)), **VAL)
    _check(tse3.quat_rotate(t1[..., 3:], tp),
           jse3.quat_rotate(jnp.asarray(q1), jnp.asarray(p)), **VAL)
    _check(tse3.quat_conj(t1[..., 3:]), jse3.quat_conj(jnp.asarray(q1)),
           rtol=0, atol=0)
    # act broadcasts one transform over many points, as the tests of the
    # JAX package use it.
    _check(tse3.act(t1[:1, :1, :1], tp),
           jse3.act(jnp.asarray(g1[:1, :1, :1]), jnp.asarray(p)), **VAL)


def test_identity_and_rotation_block():
    got = tse3.identity((2, 5))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jse3.identity((2, 5))))
    g1, _, _, _ = _fields(2)
    _check(tse3.rotation_matrix(torch.from_numpy(g1)),
           jse3.matrix(jnp.asarray(g1))[..., :3, :3], **VAL)
    assert tse3.matrix(torch.from_numpy(g1)).shape == (2, 3, 4, 4, 4)


@pytest.mark.parametrize("scale", [0.7, 1e-3, 1e-5, 0.0])
def test_exp_matches_jax_across_the_small_angle_threshold(scale):
    """theta^2 < 1e-8 takes the Taylor branch: 1e-5 and 0 are below it,
    1e-3 above. Just above it the exact branch forms (1 - cos theta) /
    theta^2 from a difference of ~5e-7 whose float32 rounding is ~6e-8: both
    sides lose the same digits but not the same bits, which moves the
    translation by up to ~1e-4 of theta * |tau|. That case is held to atol
    2e-4; its quaternion to the tolerance of the others."""
    _, _, tangent, _ = _fields(3)
    tangent = tangent.copy()
    tangent[..., 3:] *= scale / 0.7
    got = tse3.exp(torch.from_numpy(tangent))
    want = np.asarray(jse3.exp(jnp.asarray(tangent)))
    _check(got[..., 3:], want[..., 3:], **VAL)
    tol = dict(atol=2e-4, rtol=1e-5) if scale == 1e-3 else VAL
    _check(got[..., :3], want[..., :3], **tol)


def test_log_matches_jax_on_small_angles_and_negative_qw():
    g1, _, tangent, _ = _fields(4)
    cases = [g1]
    neg = g1.copy()
    neg[..., 3:] *= -1.0                      # the same rotations, qw < 0
    cases.append(neg)
    assert (g1[..., 6] < 0).any() and (neg[..., 6] < 0).any()
    for scale in (1e-2, 1e-5, 1e-7, 0.0):     # n^2 < 1e-12 from 1e-7 down
        small = tangent.copy()
        small[..., 3:] *= scale
        cases.append(np.array(jse3.exp(jnp.asarray(small))))
        flipped = cases[-1].copy()
        flipped[..., 3:] *= -1.0
        cases.append(flipped)
    for g in cases:
        _check(tse3.log(torch.from_numpy(g)), jse3.log(jnp.asarray(g)), **VAL)


def test_log_follows_jax_where_float32_cosine_rounds_to_one():
    """Between the Taylor threshold (theta^2 = 1e-8) and theta ~ 3.5e-4 the
    exact branch of ``log`` divides by 2 * (1 - cos theta), which is 0 in
    float32: the JAX function returns non-finite translations there. The
    rotation part is finite on both sides and equal. The port follows JAX's
    thresholds except exactly where that denominator is 0: there it takes
    the Taylor branch, so its translation is finite, equals a float64
    evaluation (atol 2e-6 + rtol 1e-5: V^-1 is I - [phi]x / 2 to 1e-8
    there) and has a finite gradient. (A RAFT3D field in its first
    training steps has rotations in this band. ``exp`` loses the digits of
    (1 - cos theta) / theta^2 there on both sides and stays finite.)"""
    _, _, tangent, _ = _fields(4)
    small = tangent.copy()
    small[..., 3:] *= 2e-4 / np.linalg.norm(small[..., 3:], axis=-1,
                                            keepdims=True)
    g = np.array(jse3.exp(jnp.asarray(small)))
    t = torch.from_numpy(g).requires_grad_(True)
    out = tse3.log(t)
    got = out.detach().numpy()
    want = np.asarray(jse3.log(jnp.asarray(g)))
    assert not np.isfinite(want[..., :3]).any()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[..., 3:], want[..., 3:], **VAL)
    exact = tse3.log(torch.from_numpy(g).double()).numpy()
    np.testing.assert_allclose(got[..., :3], exact[..., :3], atol=2e-6,
                               rtol=1e-5)
    out.sum().backward()
    assert torch.isfinite(t.grad).all()


def test_exp_log_round_trip():
    _, _, tangent, _ = _fields(5)
    t = torch.from_numpy(tangent * 0.5)
    back = tse3.log(tse3.exp(t))
    assert torch.isfinite(back).all()
    torch.testing.assert_close(back, t, atol=2e-6, rtol=1e-5)


def _grads(scale):
    _, _, tangent, p = _fields(6, shape=(5,))
    tangent = tangent * scale
    cot7 = np.random.RandomState(7).randn(5, 7).astype(np.float32)
    cot6 = np.random.RandomState(8).randn(5, 6).astype(np.float32)

    def jloss_exp(t):
        return jnp.sum(jse3.exp(t) * cot7)

    def jloss_log(t):
        return jnp.sum(jse3.log(jse3.exp(t)) * cot6)

    t = torch.from_numpy(tangent).requires_grad_(True)
    (tse3.exp(t) * torch.from_numpy(cot7)).sum().backward()
    g_exp = t.grad.clone()
    t.grad = None
    (tse3.log(tse3.exp(t)) * torch.from_numpy(cot6)).sum().backward()
    return ((g_exp, jax.grad(jloss_exp)(jnp.asarray(tangent))),
            (t.grad, jax.grad(jloss_log)(jnp.asarray(tangent))))


@pytest.mark.parametrize("scale", [0.5, 1e-5, 0.0])
def test_exp_and_log_gradients_are_finite_and_match_jax(scale):
    """At 0 both square roots are at their guarded operand: the gradient
    must be finite (the double ``where``) and equal to JAX's."""
    for got, want in _grads(scale):
        assert torch.isfinite(got).all()
        assert np.isfinite(np.asarray(want)).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)


def test_log_gradient_at_the_identity_is_finite_and_matches_jax():
    g = np.asarray(jse3.identity((4,))).copy()
    g[:, :3] = np.random.RandomState(9).randn(4, 3)
    cot = np.random.RandomState(10).randn(4, 6).astype(np.float32)
    t = torch.from_numpy(g).requires_grad_(True)
    (tse3.log(t) * torch.from_numpy(cot)).sum().backward()
    want = jax.grad(lambda x: jnp.sum(jse3.log(x) * cot))(jnp.asarray(g))
    assert torch.isfinite(t.grad).all()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **GRAD)


def test_group_op_gradients_match_jax():
    g1, g2, _, p = _fields(11, shape=(6,))
    cot = np.random.RandomState(12).randn(6, 7).astype(np.float32)

    def jloss(a, b, pts):
        out = jse3.mul(jse3.inv(a), jse3.normalize(b))
        return jnp.sum(out * cot) + jnp.sum(jse3.act(out, pts))

    a, b, pts = (torch.from_numpy(x).requires_grad_(True)
                 for x in (g1, g2, p))
    out = tse3.mul(tse3.inv(a), tse3.normalize(b))
    ((out * torch.from_numpy(cot)).sum() + tse3.act(out, pts).sum()).backward()
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (g1, g2, p)))
    for got, w in zip((a.grad, b.grad, pts.grad), want):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD)
