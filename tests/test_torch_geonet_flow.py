"""One float32 GeoNet stage-2 (``train_flow``) train step of the PyTorch
port against ``sndepth_tpu.train.geonet.train_step``, from the same carried
weights of DispNetS, PoseNet and FlowNet.

The JAX step runs on the CPU with its split ops (its Pallas kernels are
TPU-gated), the port's step on the CPU with the plain versions of its
kernels. Adam's first moment after one step is (1 - b1) * grad on both
sides, so the JAX gradients are read from the optimizer state of the one
compiled ``train_step``.

The consistency masks are step functions of float values (strict ``<``), so
a rounding difference can flip a pixel. They are compared first, on
identical full flows handed to both frameworks, with flows large enough
that the masks are mixed: at most 0.1% of the mask entries may differ
(measured: none). In the step itself the flows of the freshly initialised
nets are small and every mask entry is far from its bound.

Tolerances of the step: loss parts rtol 2e-5 (float32 sums over ~10^4-10^5
terms in different orders). Gradients are compared per tensor by the L2
norm of the difference over the norm of the JAX gradient. DispNetS: 5e-4
(float32 on both sides, different convolution algorithms and summation
orders through ~30 layers; measured <= 9.3e-5). FlowNet: 2e-3; its input
carries the rounding of DispNetS, PoseNet and the warps, and a float64
evaluation of the port puts both float32 sides up to 3.1e-3 from it while
they agree with each other to 9.2e-4 (measured, worst tensor
``upconv1.0.weight``). PoseNet: 1e-2 as in the stage-1 test (its gradient
is a sum over all pixels of terms that largely cancel; measured 7.4e-4).
After one Adam step the update is about lr * sign(g),
so parameters agree to atol 2e-6 (1% of lr) except where a gradient is
within rounding of zero; at most 0.1% of entries may differ there, and
none by more than 2 * lr.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sndepth_tpu.core.config import GeoNetConfig as JaxGeoNetConfig
from sndepth_tpu.ops.warp import flow_warp as jax_flow_warp
from sndepth_tpu.train import geonet as jgeo
from sndepth_tpu_torch.core.config import GeoNetConfig
from sndepth_tpu_torch.data.synthetic import synthetic_batches
from sndepth_tpu_torch.train import geonet as tgeo
from sndepth_tpu_torch.utils.layout import to_nchw, to_nhwc
from sndepth_tpu_torch.utils.threads import torch_threads
from sndepth_tpu_torch.utils.weights import (dispnet_state_dict_from_jax,
                                             flownet_state_dict_from_jax,
                                             posenet_state_dict_from_jax)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


B, H, W = 1, 32, 64
JCFG = JaxGeoNetConfig(batch_size=B, img_height=H, img_width=W,
                       compute_dtype=jnp.float32, train_flow=True)
TCFG = GeoNetConfig(batch_size=B, img_height=H, img_width=W,
                    compute_dtype=torch.float32, train_flow=True)
LR = TCFG.learning_rate
PARTS = ("loss_total", "loss_rigid_warp", "loss_disp_smooth",
         "loss_full_warp", "loss_full_smooth", "loss_geometric_consistency")
GRAD_TOL = {"disp": 5e-4, "flow": 2e-3, "pose": 1e-2}
CARRIERS = (("disp", "disp_net", dispnet_state_dict_from_jax),
            ("pose", "pose_net", posenet_state_dict_from_jax),
            ("flow", "flow_net", flownet_state_dict_from_jax))


def _batch(seed=3):
    batch = next(synthetic_batches(B, H, W, seed=seed))
    rng = np.random.RandomState(seed)
    batch["intrinsics"] = (batch["intrinsics"]
                           * rng.uniform(0.9, 1.1, (B, 3, 3))
                           ).astype(np.float32)
    return batch


def _state_dicts(tree):
    return {f"{key}.{k}": v.numpy() for key, _, carry in CARRIERS
            for k, v in carry(tree[key]).items()}


def _torch_named(state, attr):
    return {f"{key}.{k}": attr(p).detach().numpy()
            for key, name, _ in CARRIERS
            for k, p in getattr(state, name).named_parameters()}


def _jax_state():
    """``jgeo.create_train_state`` compiled: the same weights as the eager
    flax init (bit for bit), in less time. The tolerances below were
    measured on these weights; FlowNet's gradient tolerance does not hold
    for every draw of them."""
    return jax.jit(lambda: jgeo.create_train_state(JCFG))()


@pytest.fixture(scope="module")
def steps():
    jstate = _jax_state()
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstep = jax.jit(functools.partial(jgeo.train_step, config=JCFG))
    batch = _batch()
    jstate1, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    tstate = tgeo.create_train_state(TCFG, "cpu")
    for key, name, carry in CARRIERS:
        getattr(tstate, name).load_state_dict(carry(params0[key]))
    tmet = tgeo.train_step(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, TCFG)
    return dict(jstate1=jstate1, jmet=jmet, tstate=tstate, tmet=tmet,
                t_grads=_torch_named(tstate, lambda p: p.grad),
                t_params1=_torch_named(tstate, lambda p: p))


def _flows(seed, n, h, w, amp):
    """Smooth forward/backward flows (NHWC) that roughly undo each other,
    plus noise: consistency differences on both sides of the bound."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([amp * np.sin(xs / 7.0 + ys / 5.0),
                     amp * np.cos(xs / 9.0 - ys / 4.0)], -1)[None]
    fwd = base + rng.uniform(-amp, amp, (n, h, w, 2))
    bwd = -base + rng.uniform(-amp, amp, (n, h, w, 2))
    return fwd.astype(np.float32), bwd.astype(np.float32)


@pytest.mark.parametrize("s", [0, 2])
def test_consistency_masks_match_jax_on_the_same_flows(s):
    fwd, bwd = _flows(5 + s, 2, 16, 24, 4.0)
    a, beta = JCFG.geometric_consistency_alpha, JCFG.geometric_consistency_beta
    jf, jb = jnp.asarray(fwd), jnp.asarray(bwd)
    jdiff = jnp.abs(jax_flow_warp(jb, jf) + jf)
    jbound = jnp.maximum(beta * jnp.abs(jf) * 2 ** s, a)
    jmask = np.asarray(jnp.mean((jdiff * 2 ** s < jbound).astype(jnp.float32),
                                -1, keepdims=True))
    diff, mask = tgeo._consistency(torch.from_numpy(to_nchw(fwd)),
                                   torch.from_numpy(to_nchw(bwd)), s, TCFG)
    mask = to_nhwc(mask.numpy())
    assert 0.05 < jmask.mean() < 0.95, "the case must mix both outcomes"
    assert (mask != jmask).mean() <= 1e-3
    np.testing.assert_allclose(to_nhwc(diff.numpy()), np.asarray(jdiff),
                               rtol=1e-5, atol=1e-5)


def test_consistency_bound_and_mask_carry_no_gradient():
    fwd, bwd = _flows(9, 1, 8, 12, 2.0)
    f = torch.from_numpy(to_nchw(fwd)).requires_grad_(True)
    b = torch.from_numpy(to_nchw(bwd)).requires_grad_(True)
    diff, mask = tgeo._consistency(f, b, 1, TCFG)
    assert not mask.requires_grad
    diff.sum().backward()
    assert torch.isfinite(f.grad).all() and torch.isfinite(b.grad).all()
    assert float(f.grad.abs().sum()) > 0 and float(b.grad.abs().sum()) > 0


def test_flow_step_loss_parts_match_jax(steps):
    assert set(steps["tmet"]) == set(PARTS) == set(steps["jmet"])
    for key in PARTS:
        got = float(steps["tmet"][key])
        assert np.isfinite(got), key
        np.testing.assert_allclose(got, float(steps["jmet"][key]), rtol=2e-5,
                                   err_msg=key)


def test_flow_step_gradients_match_jax(steps):
    adam = steps["jstate1"].opt_state.inner_state[0]
    j_grads = _state_dicts(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1.0 - JCFG.adam_beta1), adam.mu))
    t_grads = steps["t_grads"]
    assert set(t_grads) == set(j_grads)
    assert any(k.startswith("flow.") for k in t_grads)
    for k, g in t_grads.items():
        assert np.isfinite(g).all(), k
        assert np.linalg.norm(j_grads[k]) > 0, k
        tol = GRAD_TOL[k.split(".")[0]]
        err = np.linalg.norm(g - j_grads[k]) / np.linalg.norm(j_grads[k])
        assert err <= tol, (k, err)


def test_flow_step_params_after_adam_match_jax(steps):
    j_params = _state_dicts(jax.tree_util.tree_map(
        np.asarray, steps["jstate1"].params))
    n_off, n_all = 0, 0
    for k, p in steps["t_params1"].items():
        diff = np.abs(p - j_params[k])
        assert diff.max() <= 2 * LR, k
        n_off += int((diff > 2e-6).sum())
        n_all += diff.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def test_flow_net_weights_follow_dispnet_and_posenet_from_one_seed():
    """Stage 2 draws DispNetS and PoseNet as stage 1 does and FlowNet after
    them, so switching ``train_flow`` on changes no stage-1 weight."""
    stage1 = tgeo.create_train_state(
        GeoNetConfig(batch_size=B, img_height=H, img_width=W,
                     compute_dtype=torch.float32), "cpu")
    stage2 = tgeo.create_train_state(TCFG, "cpu")
    assert stage1.flow_net is None and stage2.flow_net is not None
    for a, b in zip(stage1.parameters(), stage2.parameters()):
        assert torch.equal(a, b)
    assert len(stage2.parameters()) > len(stage1.parameters())
