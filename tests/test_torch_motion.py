"""The port's motion segmentation against ``sndepth_tpu`` on the CPU, on the
same inputs and weights, made from a seed with numpy: each residual unit
shape, both towers and the whole MotionFusionNet at full width (32x64,
B = 2, the JAX test's size) in eval and in train mode, the stride-16
transposed convolution against ``_MatmulDeconv16``, the state_dict round
trip through ``convert_motionfusion``, the cross-entropy, the staircase
schedule and Adam against optax, one train step against the JAX
``train_step``, ``eval_step``'s mIoU, the KITTIMotion reader and the
synthetic stream.

JAX parameters come from ``jax.eval_shape`` of ``init`` and numpy, once per
module, and reach the port through ``motionfusion_state_dict_from_jax``;
each JAX function is jitted once per module.

Tolerances. A unit, handed the same input, in eval and train mode: output
and every gradient 1e-4 relative by norm, running statistics 1e-5 (float32
convolutions summed in another order). Towers and the whole net in eval
mode 1e-5 by norm. The cross-entropy rtol 1e-5, its gradient 1e-4 by norm;
the schedule rtol 1e-6; Adam on given gradients, over three updates, atol
1e-9 + rtol 2e-6 of a parameter against the same updates in float64, and
against optax that plus 1e-5 of the rate an update (optax's float32 bias
correction; the test's docstring).

Train mode through the whole depth is ill-conditioned in float32: every
BatchNorm renormalises its batch statistics over 16 values a channel at
1/16 of 32x64, and an error grows by about 1.5x a unit through the 30
units; the port and JAX each part by ~1e-3 to 5e-3 from a float64
evaluation on the logits, and by ~7% globally on the gradients. So the
whole net in train mode is held at 1e-2 by norm, in float32 and in float64
(the port's float64 evaluation is what JAX's float32 one approximates), and
the train step runs on a cut plan of 10 units (each tower keeps its two
stride-2 units and ends at its full width; the fusion head keeps a plain, a
dilated and the last unit), as the NNET tests cut the encoder to a block a
stage: there float32 evaluations agree to ~2e-5. The step: loss rtol 1e-5,
pixel accuracy within one pixel in 1000, each tensor's gradient within
2e-2 of its norm (the norm floored at 1e-5 of the global norm; a
convolution's bias, zero in exact arithmetic before a BatchNorm on batch
statistics, within 1e-6 of the global norm on both sides), the
weights after the update no entry more than 2 learning rates from JAX's
(the first Adam update is the rate times the gradient's sign) and at most
2% more than a hundredth of a rate off, the running statistics within
1e-5. Every output and gradient is asserted finite.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from sndepth_tpu.data import kitti_motion as jkm
from sndepth_tpu.losses import segmentation as jseg
from sndepth_tpu.models import motionseg as jm
from sndepth_tpu.train import motion as jmt
from sndepth_tpu.utils import metrics as jmetrics
from sndepth_tpu.utils.convert_weights import convert_motionfusion
from sndepth_tpu_torch.data import kitti_motion as tkm
from sndepth_tpu_torch.losses import segmentation as tseg
from sndepth_tpu_torch.models import motionseg as tm
from sndepth_tpu_torch.train import motion as tmt
from sndepth_tpu_torch.utils import weights
from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


B, H, W = 2, 32, 64
UNIT_TOL = 1e-4
EVAL_TOL = 1e-5
TRAIN_MODE_TOL = 1e-2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _rel(got, want):
    """Relative error by norm, after asserting shapes and finiteness."""
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _fill(shapes, seed):
    """numpy values for a tree of ``jax.eval_shape`` leaves: kernels of
    variance 1 / fan_in, BatchNorm scales near 1, variances in [0.5, 1.5),
    small biases and means."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            a = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "var":
            a = 0.5 + rng.rand(*leaf.shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.randn(*leaf.shape)
        else:                                    # bias, mean
            a = 0.1 * rng.randn(*leaf.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _inputs(seed, b=B, h=H, w=W):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(b, h, w, 3).astype(np.float32),
            "flow": rng.rand(b, h, w, 3).astype(np.float32),
            "label": rng.randint(0, 3, (b, h, w)).astype(np.int32)}


@pytest.fixture(scope="module")
def full():
    """The full-width JAX net's variables and the port's net with them."""
    net = jm.MotionFusionNet()
    x = jnp.zeros((1, H, W, 3))
    v = _fill(jax.eval_shape(lambda k: net.init(k, x, x),
                             jax.random.PRNGKey(0)), 0)
    port = tm.MotionFusionNet()
    port.load_state_dict(weights.motionfusion_state_dict_from_jax(
        v["params"], v["batch_stats"]))
    return net, v, port


@pytest.fixture(scope="module")
def jax_eval(full):
    """The JAX net's eval-mode logits on one batch, jitted, and what JAX's
    ``eval_step`` makes of them: their argmax and its ``mean_iou``
    (`sndepth_tpu/train/motion.py:89-95`)."""
    net, v, _ = full
    b = _inputs(4)
    logits = jax.jit(lambda s, i, f: net.apply(s, i, f))(v, b["image"],
                                                         b["flow"])
    pred = jnp.argmax(logits, -1)
    out = {"pred": np.asarray(pred), "miou": float(jmetrics.mean_iou(
        pred, jnp.asarray(b["label"]), logits.shape[-1]))}
    return b, out, np.asarray(logits)


# --- residual units ----------------------------------------------------------

UNITS = {
    "plain": dict(in_ch=64, mid_ch=32, out_ch=64),
    "strided_projection_relu": dict(in_ch=64, mid_ch=32, out_ch=128,
                                    stride=2, project=True,
                                    project_relu=True),
    "dual_dilated": dict(in_ch=64, mid_ch=32, out_ch=64, branch_width=32,
                         branch_dilations=(1, 2)),
    "dual_dilated_projection": dict(in_ch=64, mid_ch=32, out_ch=128,
                                    branch_width=32, branch_dilations=(2, 4),
                                    project=True),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", list(UNITS))
def test_residual_unit_matches_jax(kind, train):
    """Output, the gradients of the input and of every parameter under a
    random cotangent, and in train mode the moved running statistics, on a
    7x13 input (odd sides: the strided shortcut's "SAME" padding). In train
    mode a convolution's bias has a gradient that is zero in exact
    arithmetic (its BatchNorm subtracts the batch mean): both sides' are
    held to 1e-6 of the global gradient norm instead."""
    jspec, tspec = jm.UnitSpec(**UNITS[kind]), tm.UnitSpec(**UNITS[kind])
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 13, jspec.in_ch).astype(np.float32)
    unit = jm.ResidualUnit(jspec)
    v = _fill(jax.eval_shape(lambda k: unit.init(k, jnp.asarray(x)),
                             jax.random.PRNGKey(0)), 2)

    def f(params, xx):
        out, mut = unit.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, xx, train,
                              mutable=["batch_stats"])
        return out, mut["batch_stats"]

    @jax.jit
    def forward_and_vjp(params, xx, cot):
        (out, new_stats), vjp = jax.vjp(f, params, xx)
        return out, new_stats, vjp((cot, jax.tree_util.tree_map(
            jnp.zeros_like, new_stats)))

    h_out = (7 + jspec.stride - 1) // jspec.stride
    w_out = (13 + jspec.stride - 1) // jspec.stride
    cot = rng.randn(2, h_out, w_out, jspec.out_ch).astype(np.float32)
    out, new_stats, (gp, gx) = forward_and_vjp(v["params"], jnp.asarray(x),
                                               jnp.asarray(cot))

    def port_sd(params, stats):
        sd = {}
        weights._residual_unit(sd, "u", tspec, params, stats)
        return {k[2:]: t for k, t in sd.items()}

    port = tm.ResidualUnit(tspec)
    port.load_state_dict(port_sd(v["params"], v["batch_stats"]))
    port.train(train)
    xt = _nchw(x).requires_grad_(True)
    got = port(xt)
    (got * _nchw(cot)).sum().backward()
    assert _rel(got.permute(0, 2, 3, 1), out) <= UNIT_TOL
    assert _rel(xt.grad.permute(0, 2, 3, 1), gx) <= UNIT_TOL
    want = port_sd(gp, v["batch_stats"])
    grads = dict(port.named_parameters())
    norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                for p in grads.values())))
    conv_biases = {f"{n}.bias" for n, m in port.named_modules()
                   if isinstance(m, torch.nn.Conv2d)}
    for name, p in grads.items():
        assert torch.isfinite(p.grad).all(), name
        if train and name in conv_biases:
            # A convolution's bias before a BatchNorm on batch statistics:
            # zero in exact arithmetic on both sides.
            for g in (p.grad, want[name]):
                assert float(g.abs().max()) <= 1e-6 * norm, name
        else:
            assert _rel(p.grad, want[name]) <= UNIT_TOL, name
    stats = port_sd(v["params"], new_stats)
    for name, buf in port.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), stats[name].numpy(),
                                       atol=1e-5, err_msg=name)


# --- towers and the whole net ------------------------------------------------

@pytest.mark.parametrize("tower", ["motion", "semantic"])
def test_tower_matches_jax_in_eval_mode(full, tower):
    net, v, port = full
    jname, cls = {"motion": ("MotionFeatureNet_0", jm.MotionFeatureNet),
                  "semantic": ("SemanticFeatureNet_0",
                               jm.SemanticFeatureNet)}[tower]
    x = _inputs(3)["flow" if tower == "motion" else "image"]
    sub = {"params": v["params"][jname],
           "batch_stats": v["batch_stats"][jname]}
    want = jax.jit(lambda s, a: cls().apply(s, a))(sub, x)
    module = (port.motionFeatureNet if tower == "motion"
              else port.semanticFeatureNet)
    with torch.no_grad():
        got = module.eval()(_nchw(x))
    assert want.shape == (B, H // 16, W // 16, 512 if tower == "motion"
                          else 2048)
    assert _rel(got.permute(0, 2, 3, 1), want) <= EVAL_TOL


def test_motion_fusion_net_matches_jax_in_eval_mode(full, jax_eval):
    _, _, port = full
    b, _, want = jax_eval
    with torch.no_grad():
        got = port.eval()(_nchw(b["image"]), _nchw(b["flow"]))
    assert got.dtype == torch.float32 and want.shape == (B, H, W, 3)
    assert _rel(got.permute(0, 2, 3, 1), want) <= EVAL_TOL


def test_motion_fusion_net_matches_jax_in_train_mode(full):
    """Batch statistics through the whole depth: the logits against JAX's
    in float32, and the port's float64 evaluation against JAX's float32 one
    (the module docstring says why 1e-2); the running statistics the
    forward moved, within 1e-3 of each tensor's largest entry."""
    net, v, port = full
    b = _inputs(5)
    want, mut = jax.jit(lambda s, i, f: net.apply(
        s, i, f, train=True, mutable=["batch_stats"]))(v, b["image"],
                                                       b["flow"])
    port64 = tm.MotionFusionNet(dtype=torch.float64)
    port64.load_state_dict(port.state_dict())
    port64.double()
    with torch.no_grad():
        got = port.train()(_nchw(b["image"]), _nchw(b["flow"]))
        got64 = port64.train()(*(_nchw(b[k]).double()
                                 for k in ("image", "flow")))
    port.load_state_dict(weights.motionfusion_state_dict_from_jax(
        v["params"], v["batch_stats"]))    # the fixture's statistics back
    assert _rel(got.permute(0, 2, 3, 1), want) <= TRAIN_MODE_TOL
    assert _rel(got64.permute(0, 2, 3, 1), want) <= TRAIN_MODE_TOL
    stats = weights.motionfusion_state_dict_from_jax(v["params"],
                                                     mut["batch_stats"])
    for name, buf in port64.named_buffers():
        if "running" in name:
            scale = float(stats[name].abs().max())
            assert float((buf - stats[name]).abs().max()) <= 1e-3 * scale, \
                name


def test_transposed_conv_matches_matmul_deconv16():
    """The head as ``F.conv_transpose2d`` with the flipped-back taps of
    ``motionfusion_state_dict_from_jax`` against the JAX matmul form."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 5, 32).astype(np.float32)
    deconv = jm._MatmulDeconv16(3)
    v = _fill(jax.eval_shape(lambda k: deconv.init(k, jnp.asarray(x)),
                             jax.random.PRNGKey(0)), 7)
    want = deconv.apply(v, jnp.asarray(x))
    w = torch.from_numpy(np.ascontiguousarray(
        np.asarray(v["params"]["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)))
    got = torch.nn.functional.conv_transpose2d(
        _nchw(x), w, _t(v["params"]["bias"]), 16)
    assert want.shape == (2, 48, 80, 3)
    assert _rel(got.permute(0, 2, 3, 1), want) <= EVAL_TOL


def test_state_dict_round_trip_through_convert_motionfusion_is_exact(full):
    """The port's state_dict has the reference's names and maps back into
    the same JAX variables bit for bit."""
    _, v, port = full
    sd = port.state_dict()
    for key in ("motionFeatureNet.layer1.0.weight",
                "motionFeatureNet.layer3.0.layer_1.6.weight",
                "motionFeatureNet.layer3.0.layer_2.1.running_var",
                "semanticFeatureNet.layer1.4.bias",
                "semanticFeatureNet.layer3.13.down_conv.0.weight",
                "layer1.3.initial_conv.1.weight", "layer1.7.branch2.0.bias",
                "layer1.7.final_conv.0.weight", "layer2.0.weight",
                "layer3.0.weight", "layer3.1.running_mean"):
        assert key in sd, key
    assert sd["layer3.0.weight"].shape == (2048, 3, 16, 16)
    back = convert_motionfusion({k: t.numpy() for k, t in sd.items()})
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    want = jax.tree_util.tree_leaves_with_path(v)
    assert len(got) == len(want) > 700
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


# --- loss, schedule, optimizer -----------------------------------------------

@pytest.mark.parametrize("weighted", [False, True],
                         ids=["plain", "class_weights"])
def test_cross_entropy_matches_jax(weighted):
    """Values and gradients; the weighted form as ``weighted_motion_ce``
    (background weight 0) and with unequal weights."""
    rng = np.random.RandomState(8)
    logits = (3 * rng.randn(2, 5, 7, 3)).astype(np.float32)
    labels = rng.randint(0, 3, (2, 5, 7)).astype(np.int32)
    cases = ([(tseg.cross_entropy, jseg.cross_entropy, ())] if not weighted
             else [(tseg.weighted_motion_ce, jseg.weighted_motion_ce, ()),
                   (tseg.cross_entropy, jseg.cross_entropy,
                    ((0.5, 2.0, 1.0),))])
    for tfn, jfn, extra in cases:
        want, grad = jax.value_and_grad(
            lambda z: jfn(z, jnp.asarray(labels), *map(jnp.asarray, extra)))(
                jnp.asarray(logits))
        lt = _t(logits).requires_grad_(True)
        got = tfn(lt, _t(labels), *extra)
        got.backward()
        assert np.isfinite(float(got.detach()))
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
        assert _rel(lt.grad, grad) <= UNIT_TOL


@pytest.mark.parametrize("count", [0, 2999, 3000, 6000])
def test_staircase_schedule_matches_optax(count):
    want = optax.exponential_decay(0.01, 3000, 0.9, staircase=True)(count)
    np.testing.assert_allclose(tmt.lr_at(count), float(want), rtol=1e-6)


def test_three_adam_updates_match_optax():
    """``make_optimizer()`` (Adam on the staircase) against
    ``torch.optim.Adam`` at :func:`lr_at`, over three updates across the
    step at count 3000 (the schedule's count starts at 2998 on both sides;
    Adam's bias correction counts from 1), and both against the same three
    updates in float64. The port is held to the float64 updates at atol
    1e-9 + rtol 2e-6; to optax at that plus 1e-5 of the rate an update:
    optax forms its bias correction 1 - 0.999^t in float32, where 0.999
    rounds to 0.99900001, so its second moment's correction is 1.3e-5 off
    and its updates ~6e-6 (1.6-2.3e-7 measured against float64, where the
    port's are 2.5e-8)."""
    rng = np.random.RandomState(9)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    tx = jmt.make_optimizer()
    adam_state, sched_state = tx.init(params)
    opt_state = (adam_state, sched_state._replace(count=jnp.asarray(2998)))
    leaves = jax.tree_util.tree_leaves(params)
    tparams = [torch.nn.Parameter(_t(a).clone()) for a in leaves]
    exact = [a.astype(np.float64) for a in leaves]
    moments = [(0.0 * a, 0.0 * a) for a in exact]
    opt = torch.optim.Adam(tparams, lr=tmt.lr_at(0), betas=(0.9, 0.999),
                           eps=1e-8)
    update = jax.jit(tx.update)
    for t, count in enumerate(range(2998, 3001), 1):
        grads = jax.tree_util.tree_map(
            lambda a: rng.randn(*a.shape).astype(np.float32), params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for i, (p, g) in enumerate(zip(tparams,
                                       jax.tree_util.tree_leaves(grads))):
            p.grad = _t(g).clone()
            m, v = moments[i]
            g = np.asarray(g, np.float64)
            m, v = 0.9 * m + 0.1 * g, 0.999 * v + 0.001 * g * g
            moments[i] = m, v
            exact[i] = exact[i] - tmt.lr_at(count) * (m / (1 - 0.9 ** t)) / (
                np.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
        for group in opt.param_groups:
            group["lr"] = tmt.lr_at(count)
        opt.step()
    assert tmt.lr_at(2999) != tmt.lr_at(3000)
    for p, want, ref in zip(tparams, jax.tree_util.tree_leaves(params),
                            exact):
        np.testing.assert_allclose(p.detach().numpy(), ref, atol=1e-9,
                                   rtol=2e-6)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   atol=1e-9 + 3 * 1e-5 * tmt.lr_at(0),
                                   rtol=2e-6)


# --- one train step against the JAX package's --------------------------------

_CUT = {
    "MOTION_UNITS": lambda u: (
        u(64, 64, 256, 1, project=True, project_relu=True),
        u(256, 256, 512, 2, project=True, project_relu=True),
        u(512, 256, 512, 2, project=True, project_relu=True)),
    "SEMANTIC_UNITS": lambda u: (
        u(64, 64, 256, 1, project=True, project_relu=True),
        u(256, 256, 512, 2, project=True, project_relu=True),
        u(512, 768, 1024, 2, project=True, project_relu=True),
        u(1024, 512, 2048, branch_width=256, branch_dilations=(2, 4),
          project=True)),
    "FUSION_UNITS": lambda u: (
        u(2560, 128, 512, 1, project=True, project_relu=True),
        u(512, 256, 1024, branch_width=128, branch_dilations=(1, 2),
          project=True),
        u(1024, 512, 2048, branch_width=256, branch_dilations=(4, 16),
          project=True)),
}


def _carrying_optimizer(make):
    """``make()``'s optimizer, its state extended by the last gradients it
    was given, so that the JAX ``train_step`` hands them out unchanged."""
    def wrapped():
        tx = make()

        def update(grads, state, params=None):
            updates, inner = tx.update(grads, state[0], params)
            return updates, (inner, grads)

        return optax.GradientTransformation(
            lambda p: (tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)),
            update)
    return wrapped


@pytest.fixture(scope="module")
def steps():
    """One train step on both sides from the same weights and batch, on the
    cut plan; the JAX ``train_step`` jitted once."""
    with pytest.MonkeyPatch.context() as mp:
        for name, plan in _CUT.items():
            mp.setattr(jm, name, plan(jm.UnitSpec))
            mp.setattr(tm, name, plan(tm.UnitSpec))
        mp.setattr(jmt, "make_optimizer",
                   _carrying_optimizer(jmt.make_optimizer))
        net = jm.MotionFusionNet()
        x = jnp.zeros((1, H, W, 3))
        v = _fill(jax.eval_shape(lambda k: net.init(k, x, x),
                                 jax.random.PRNGKey(0)), 10)
        params, stats = v["params"], v["batch_stats"]
        batch = _inputs(11)
        state = jmt.MotionTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=jmt.make_optimizer().init(params))
        jnew, jmetrics = jax.device_get(jax.jit(jmt.train_step)(
            state, {k: jnp.asarray(a) for k, a in batch.items()}))
        model = tm.MotionFusionNet()
        model.load_state_dict(weights.motionfusion_state_dict_from_jax(
            params, stats))
        to_sd = weights.motionfusion_state_dict_from_jax
        tstate = tmt.create_train_state(model, "cpu")
        before = {k: t.clone() for k, t in model.state_dict().items()}
        metrics = tmt.train_step(tstate, {k: _t(a) for k, a in batch.items()})
        return {"jgrads": to_sd(jnew.opt_state[1], stats),
                "jnew": to_sd(jnew.params, jnew.batch_stats),
                "jmetrics": jmetrics, "jstep": int(jnew.step),
                "state": tstate, "metrics": metrics, "before": before}


def test_train_step_loss_and_accuracy_match_jax(steps):
    got, want = steps["metrics"], steps["jmetrics"]
    assert np.isfinite(float(got["loss"]))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    assert abs(float(got["pixel_acc"]) - float(want["pixel_acc"])) <= 1e-3
    assert steps["state"].step == steps["jstep"] == 1


def test_train_step_gradients_match_jax_tensor_by_tensor(steps):
    """Each tensor's gradient; a convolution's bias, whose gradient is zero
    in exact arithmetic (its BatchNorm subtracts the batch mean), is held to
    1e-6 of the global norm on both sides instead."""
    named = dict(steps["state"].model.named_parameters())
    assert len(named) > 100
    norm = float(np.sqrt(sum(float((p.grad.double() ** 2).sum())
                             for p in named.values())))
    conv_biases = {f"{n}.bias" for n, m in steps["state"].model.named_modules()
                   if isinstance(m, (torch.nn.Conv2d,
                                     torch.nn.ConvTranspose2d))}
    worst = 0.0
    for name, p in named.items():
        want = steps["jgrads"][name]
        assert torch.isfinite(p.grad).all(), name
        if name in conv_biases:
            # Before a BatchNorm on batch statistics: zero in exact
            # arithmetic on both sides.
            for g in (p.grad, want):
                assert float(g.norm()) <= 1e-6 * norm, name
            continue
        err = float((p.grad - want).norm()
                    / want.norm().clamp_min(1e-5 * norm))
        assert err <= 2e-2, f"{name}: {err}"
        worst = max(worst, err)
    assert worst > 0.0


def test_train_step_updated_parameters_match_jax(steps):
    lr = tmt.lr_at(0)
    n_off = n_all = 0
    for name, p in steps["state"].model.named_parameters():
        d = (p.detach() - steps["jnew"][name]).abs()
        assert float(d.max()) <= 2.0 * lr * 1.001, name
        n_off += int((d > 0.01 * lr).sum())
        n_all += d.numel()
        assert not torch.equal(p.detach(), steps["before"][name]), name
    assert n_off <= 0.02 * n_all, n_off / n_all


def test_train_step_carries_the_batch_statistics(steps):
    """The running averages move as JAX's ``batch_stats`` do: 0.99 of the
    old plus 0.01 of the batch's mean and biased variance."""
    moved = 0
    for name, buf in steps["state"].model.named_buffers():
        if "running" not in name:
            continue
        np.testing.assert_allclose(buf.numpy(), steps["jnew"][name].numpy(),
                                   atol=1e-5, err_msg=name)
        moved += not torch.equal(buf, steps["before"][name])
    assert moved > 50


def test_eval_step_miou_matches_jax(full, jax_eval):
    """``eval_step`` on the running statistics: the class map and its mIoU
    against JAX's (a pixel may differ only where JAX's top two logits lie
    within 1e-4); the model's train mode is left as it was."""
    port = full[2]
    b, want, logits = jax_eval
    logits = np.sort(logits, -1)
    port.train()
    got = tmt.eval_step(port, {k: _t(a) for k, a in b.items()})
    assert port.training
    differ = got["pred"].numpy() != want["pred"]
    assert not (differ & (logits[..., -1] - logits[..., -2] > 1e-4)).any()
    if not differ.any():
        np.testing.assert_allclose(float(got["miou"]), float(want["miou"]),
                                   rtol=1e-6)


# --- data --------------------------------------------------------------------

def _motion_tree(root, n, h, w, seed):
    rng = np.random.RandomState(seed)
    for split in ("train", "val"):
        for sub in ("image", "flow", "label"):
            os.makedirs(os.path.join(root, split, sub))
        for i in range(n):
            for sub in ("image", "flow"):
                Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
                    os.path.join(root, split, sub, f"{i:06d}.png"))
            label = np.zeros((h, w, 3), np.uint8)
            label[..., 0] = 100 * rng.randint(0, 3, (h, w))
            Image.fromarray(label).save(
                os.path.join(root, split, "label", f"{i:06d}.png"))


def test_kitti_motion_dataset_matches_jax(tmp_path):
    _motion_tree(str(tmp_path), 3, 10, 14, 13)
    for train in (True, False):
        got = tkm.KITTIMotionDataset(str(tmp_path), train)
        want = jkm.KITTIMotionDataset(str(tmp_path), train)
        assert len(got) == len(want) == 3
        for i in range(3):
            for k in ("image", "flow", "label"):
                np.testing.assert_array_equal(got[i][k], want[i][k])
                assert got[i][k].dtype == want[i][k].dtype
        assert set(np.unique(got[0]["label"])) <= {0, 1, 2}
    os.remove(tmp_path / "val" / "flow" / "000001.png")
    with pytest.raises(ValueError, match="mismatched counts"):
        tkm.KITTIMotionDataset(str(tmp_path), train=False)


def test_synthetic_motion_batches_are_bit_equal():
    got = tkm.synthetic_motion_batches(2, 8, 12, seed=3)
    want = jkm.synthetic_motion_batches(2, 8, 12, seed=3)
    for _ in range(3):
        g, w = next(got), next(want)
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
