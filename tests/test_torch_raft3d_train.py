"""The port's RAFT3D training against ``sndepth_tpu.train.raft3d`` on the CPU,
on the same inputs and weights, made from a seed with numpy: the sequence
loss (values and gradients), the one-cycle schedule and the clipped AdamW
update against optax, the gradients of the model's pieces that only training
differentiates (the correlation lookup, whose JAX side has a hand-written
VJP; the induced flow; the Gauss-Newton step), one whole train step against
``train_step`` of the JAX package, and the checkpoint.

The JAX step is jitted once for the module (64x80, B = 1, 2 iterations,
float32); its parameters come from ``jax.eval_shape`` and numpy and reach the
port through ``raft3d_state_dict_from_jax``, as do its gradients and its
updated parameters on the way back.

Tolerances. Sequence loss: rtol 1e-5 on values, atol 1e-7 + rtol 1e-4 on
gradients (means over 15,360 entries). Schedule: rtol 1e-6 (optax
interpolates in float32). AdamW on given gradients: atol 1e-9 + rtol 2e-6 of a
parameter after three updates. Gradients of the pieces: rtol 1e-3 + atol 1e-3
of the largest entry (float32 sums in another order). The train step: loss
and epe2d rtol 1e-4; each tensor's gradient to 2e-2 of its norm (the norm
floored at 1e-5 of the global norm: a bias before an instance norm has a
gradient that is zero in exact arithmetic); after the update no entry more
than 2 learning rates from JAX's (the first Adam update is the rate times
the gradient's sign, and a gradient within rounding of zero may take either)
and at most 2% more than a hundredth of a rate off. Every loss and gradient
is asserted finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sndepth_tpu.models import raft3d as jraft
from sndepth_tpu.ops import projective as jpops
from sndepth_tpu.ops import se3 as jse3
from sndepth_tpu.train import raft3d as jrt
from sndepth_tpu_torch.models import raft3d as traft
from sndepth_tpu_torch.ops import projective as tpops
from sndepth_tpu_torch.train import loop
from sndepth_tpu_torch.train import raft3d as rt
from sndepth_tpu_torch.utils.layout import to_nchw
from sndepth_tpu_torch.utils.threads import torch_threads
from sndepth_tpu_torch.utils.weights import raft3d_state_dict_from_jax

H, W, ITERS = 64, 80, 2


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _batch(seed=0, b=1, h=H, w=W):
    rng = np.random.RandomState(seed)
    valid = (rng.rand(b, h, w) > 0.3).astype(np.float32)
    return {
        "image1": rng.rand(b, h, w, 3).astype(np.float32),
        "image2": rng.rand(b, h, w, 3).astype(np.float32),
        "depth1": (2 + rng.rand(b, h, w)).astype(np.float32),
        "depth2": (2 + rng.rand(b, h, w)).astype(np.float32),
        "flow": (0.5 * rng.randn(b, h, w, 3)).astype(np.float32),
        "valid": valid,
        "intrinsics": np.tile(
            np.array([w * 0.6, w * 0.6, w / 2, h / 2], np.float32), (b, 1)),
    }


# ----------------------------------------------------------------------
# Sequence loss
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mask", ["all", "partial", "none"])
def test_sequence_loss_matches_jax_in_value_and_gradient(mask):
    """A full, a partly invalid and an all-invalid mask: with no valid pixel
    the loss and its gradients are exactly 0 (the 1e-8 in the
    denominators), not NaN."""
    rng = np.random.RandomState(3)
    n, b, h, w = 3, 2, 8, 10
    est = rng.randn(n, b, h, w, 3).astype(np.float32)
    rev = rng.randn(n, b, h, w, 2).astype(np.float32)
    gt = rng.randn(b, h, w, 3).astype(np.float32)
    valid = {"all": np.ones((b, h, w), np.float32),
             "partial": (rng.rand(b, h, w) > 0.4).astype(np.float32),
             "none": np.zeros((b, h, w), np.float32)}[mask]
    te, tr = _t(est).requires_grad_(True), _t(rev).requires_grad_(True)
    loss, metrics = rt.sequence_loss(te, tr, _t(gt), _t(valid), gamma=0.8)
    loss.backward()
    (jl, jm), jg = jax.value_and_grad(
        lambda e, r: jrt.sequence_loss(e, r, jnp.asarray(gt),
                                       jnp.asarray(valid), 0.8),
        argnums=(0, 1), has_aux=True)(jnp.asarray(est), jnp.asarray(rev))
    assert set(metrics) == {"loss", "epe2d"} and metrics["loss"] is loss
    for got, want in ((loss, jl), (metrics["epe2d"], jm["epe2d"])):
        assert np.isfinite(float(got.detach()))
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
    for got, want in ((te.grad, jg[0]), (tr.grad, jg[1])):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7,
                                   rtol=1e-4)
    if mask == "none":
        assert float(loss.detach()) == 0.0
        assert float(te.grad.abs().max()) == 0.0


# ----------------------------------------------------------------------
# Schedule, clipping, AdamW
# ----------------------------------------------------------------------

@pytest.mark.parametrize("total,lr", [(200_000, 2e-4), (1000, 1e-3), (7, 0.5)])
def test_onecycle_schedule_matches_optax(total, lr):
    """At a dozen counts, the boundaries (0.3 and 0.85 of the total, cut to
    integers), their neighbours, the end and beyond it included."""
    want = optax.linear_onecycle_schedule(total, lr)
    b1, b2 = int(0.3 * total), int(0.85 * total)
    counts = sorted({0, 1, b1 - 1, b1, b1 + 1, (b1 + b2) // 2, b2 - 1, b2,
                     b2 + 1, total - 1, total, total + 5, 3 * total} - {-1})
    assert len(counts) >= 7
    for count in counts:
        np.testing.assert_allclose(rt.onecycle_lr(count, lr, total),
                                   float(want(count)), rtol=1e-6,
                                   err_msg=str(count))
    assert rt.onecycle_lr(0, lr, total) == pytest.approx(lr / 25)
    assert rt.onecycle_lr(b1, lr, total) == pytest.approx(lr)


def _param_tree(rng):
    return {"a": rng.randn(3, 4).astype(np.float32),
            "b": {"bias": rng.randn(5).astype(np.float32),
                  "w": rng.randn(2, 2, 3).astype(np.float32)}}


@pytest.mark.parametrize("scale", [0.05, 30.0], ids=["below_1", "above_1"])
def test_clip_by_global_norm_matches_optax(scale):
    """The norm below the bound leaves the gradients untouched (optax does
    not divide by norm + 1e-6 as ``torch.nn.utils.clip_grad_norm_`` does);
    above it they are scaled to norm 1."""
    rng = np.random.RandomState(5)
    grads = jax.tree_util.tree_map(lambda a: a * np.float32(scale),
                                   _param_tree(rng))
    want, _ = optax.clip_by_global_norm(1.0).update(grads, optax.EmptyState())
    leaves = [_t(a).clone() for a in jax.tree_util.tree_leaves(grads)]
    before = [a.clone() for a in leaves]
    norm = rt.clip_by_global_norm_(leaves)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                               rtol=1e-6)
    for got, w, b in zip(leaves, jax.tree_util.tree_leaves(want), before):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6)
        if scale < 1:
            assert torch.equal(got, b)


@pytest.mark.parametrize("scale", [0.05, 30.0], ids=["below_1", "above_1"])
def test_three_clipped_adamw_updates_match_optax(scale):
    """``optax.chain(clip_by_global_norm(1), adamw(onecycle))`` against the
    port's clip, schedule and ``torch.optim.AdamW`` on the same three
    gradients; the first update uses the schedule at count 0, and the decay
    (1e-5, on every parameter) rides the scheduled rate."""
    rng = np.random.RandomState(6)
    params = _param_tree(rng)
    tx = jrt.make_optimizer()
    opt_state = tx.init(params)
    tparams = [torch.nn.Parameter(_t(a).clone())
               for a in jax.tree_util.tree_leaves(params)]
    opt = rt.make_optimizer(tparams)
    assert opt.param_groups[0]["lr"] == pytest.approx(2e-4 / 25)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: (scale * rng.randn(*a.shape)).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for p, g in zip(tparams, jax.tree_util.tree_leaves(grads)):
            p.grad = _t(g).clone()
        rt.clip_by_global_norm_([p.grad for p in tparams])
        for group in opt.param_groups:
            group["lr"] = rt.onecycle_lr(step)
        opt.step()
    for p, want in zip(tparams, jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   atol=1e-9, rtol=2e-6)


# ----------------------------------------------------------------------
# Gradients of the pieces that only training differentiates
# ----------------------------------------------------------------------

def _grad_close(got, want, name=""):
    want = np.asarray(want)
    assert torch.isfinite(got).all(), name
    assert np.isfinite(want).all(), name
    np.testing.assert_allclose(
        got.numpy(), want, rtol=1e-3,
        atol=1e-3 * max(float(np.abs(want).max()), 1e-30), err_msg=name)


def test_corr_lookup_dot_gradients_match_the_jax_custom_vjp():
    """The JAX lookup gathers slabs through ``_slab_gather``, whose adjoint
    is written by hand as a one-hot product; the port's gather is
    differentiated by autograd (a scatter-add). Gradients in the query
    features, in every pyramid level and in the coordinates, with queries
    inside, at the border of and outside the image."""
    rng = np.random.RandomState(7)
    b, c, h, w = 2, 16, 8, 10
    f1 = rng.randn(b, h, w, c).astype(np.float32)
    f2 = rng.randn(b, h, w, c).astype(np.float32)
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None]
    coords = (coords + 3.0 * rng.randn(b, h, w, 2)).astype(np.float32)
    coords[0, 0, 0] = (-20.0, 3.0)
    coords[1, 2, 3] = (w - 0.5, h - 0.5)
    cot = rng.randn(b, h, w, 3 * 49).astype(np.float32)

    def jloss(f1, f2, coords):
        pyr = jraft.pool_fmap_pyramid(f2, 3)
        return jnp.sum(jraft.corr_lookup_dot(f1, pyr, coords, 3) * cot)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (f1, f2, coords)))
    t1 = _t(to_nchw(f1)).requires_grad_(True)
    t2 = _t(to_nchw(f2)).requires_grad_(True)
    tc = _t(coords).requires_grad_(True)
    out = traft.corr_lookup_dot(t1, traft.pool_fmap_pyramid(t2, 3), tc, 3)
    (out * _t(to_nchw(cot))).sum().backward()
    _grad_close(t1.grad.permute(0, 2, 3, 1), want[0], "fmap1")
    _grad_close(t2.grad.permute(0, 2, 3, 1), want[1], "fmap2")
    _grad_close(tc.grad, want[2], "coords")


def test_induced_flow_and_normalize_gradients_match_jax():
    rng = np.random.RandomState(8)
    b, h, w = 2, 6, 7
    Ts = np.array(jse3.exp(jnp.asarray(
        (0.1 * rng.randn(b, h, w, 6)).astype(np.float32))))
    Ts[..., 3:] *= 1.0 + 0.05 * rng.randn(b, h, w, 1).astype(np.float32)
    depth = (1.5 + rng.rand(b, h, w)).astype(np.float32)
    k = np.array([[20.0, 21.0, 3.0, 3.5]] * b, np.float32)
    cot2, cot3 = (rng.randn(b, h, w, 3).astype(np.float32) for _ in range(2))

    def jloss(Ts):
        flow2d, flow3d, _ = jpops.induced_flow(jse3.normalize(Ts),
                                               jnp.asarray(depth),
                                               jnp.asarray(k))
        return jnp.sum(flow2d * cot2) + jnp.sum(flow3d * cot3)

    t = _t(Ts).requires_grad_(True)
    from sndepth_tpu_torch.ops import se3 as tse3
    flow2d, flow3d, _ = tpops.induced_flow(tse3.normalize(t), _t(depth),
                                           _t(k))
    ((flow2d * _t(cot2)).sum() + (flow3d * _t(cot3)).sum()).backward()
    _grad_close(t.grad, jax.jit(jax.grad(jloss))(jnp.asarray(Ts)), "Ts")


@pytest.mark.parametrize("radius", [2, 32])
def test_gauss_newton_step_gradients_match_jax(radius):
    """In the embedding, the target and the confidence, which a train step
    differentiates, and in the field; through the build, the damped solve,
    the exponential and the composition."""
    rng = np.random.RandomState(9)
    b, h, w = 1, 6, 8
    Ts = np.array(jse3.exp(jnp.asarray(
        (0.05 * rng.randn(b, h, w, 6)).astype(np.float32))))
    ae = rng.randn(b, h, w, 32).astype(np.float32)
    depth = (1.5 + rng.rand(b, h, w)).astype(np.float32)
    intr = np.array([[20.0, 21.0, 4.0, 3.0]], np.float32)
    weight = rng.rand(b, h, w, 3).astype(np.float32)
    coords, _ = jpops.projective_transform(
        jnp.asarray(Ts), jnp.asarray(depth), jnp.asarray(intr))
    target = (np.asarray(coords) + 0.3 * rng.randn(b, h, w, 3)
              * [1, 1, 0.01]).astype(np.float32)
    cot = rng.randn(b, h, w, 7).astype(np.float32)

    def jloss(Ts, ae, target, weight):
        out = jraft.gauss_newton_step(Ts, ae, target, weight,
                                      jnp.asarray(depth), jnp.asarray(intr),
                                      radius=radius)
        return jnp.sum(out * cot)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (Ts, ae, target, weight)))
    leaves = [_t(a).requires_grad_(True) for a in (Ts, ae, target, weight)]
    out = traft.gauss_newton_step(*leaves, _t(depth), _t(intr), radius=radius)
    (out * _t(cot)).sum().backward()
    for name, leaf, w_ in zip(("Ts", "ae", "target", "weight"), leaves, want):
        _grad_close(leaf.grad, w_, name)


def test_batchnorm_stays_on_running_statistics_in_train_mode():
    """``model.train()`` must change nothing: the context net normalises
    with its running statistics and never updates them."""
    model = traft.RAFT3D()
    traft.init_weights(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    x = _t(to_nchw(_batch(1)["image1"]))
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    with torch.no_grad():
        a = model.eval().cnet(x)
        b = model.train().cnet(x)
    assert model.training and torch.equal(a, b)
    for n, buf in model.named_buffers():
        assert torch.equal(buf, buffers[n]), n


# ----------------------------------------------------------------------
# One train step against the JAX package's
# ----------------------------------------------------------------------

def _variables():
    model = jraft.RAFT3D()
    bt = _batch()
    frame = tuple(jnp.asarray(bt[k]) for k in
                  ("image1", "image2", "depth1", "depth2", "intrinsics"))
    shapes = jax.eval_shape(
        lambda key: model.init(key, *frame, iters=1), jax.random.PRNGKey(0))
    rng = np.random.RandomState(11)

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

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def steps():
    """One train step on both sides from the same weights and batch."""
    jmodel, variables = _variables()
    params, stats = variables["params"], variables["batch_stats"]
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def jax_step(state):
        def loss_fn(p):
            est, rev, _ = jmodel.apply(
                {"params": p, "batch_stats": state.batch_stats},
                jbatch["image1"], jbatch["image2"], jbatch["depth1"],
                jbatch["depth2"], jbatch["intrinsics"], iters=ITERS,
                train_mode=True)
            return jrt.sequence_loss(est, rev, jbatch["flow"],
                                     jbatch["valid"])[0]
        grads = jax.grad(loss_fn)(state.params)
        new_state, metrics = jrt.train_step(state, jbatch, jmodel,
                                            iters=ITERS)
        return grads, new_state, metrics

    jstate = jrt.RAFT3DTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=jrt.make_optimizer().init(params))
    jgrads, jnew, jmetrics = jax.device_get(jax_step(jstate))

    model = traft.RAFT3D()
    model.load_state_dict(raft3d_state_dict_from_jax(params, stats))
    state = rt.create_train_state(model, "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = rt.train_step(state, {k: _t(v) for k, v in batch.items()},
                            iters=ITERS)
    return {"jgrads": raft3d_state_dict_from_jax(jgrads, stats),
            "jparams": raft3d_state_dict_from_jax(jnew.params, stats),
            "jmetrics": jmetrics, "jstep": int(jnew.step), "state": state,
            "metrics": metrics, "before": before, "batch": batch}


def test_train_step_loss_and_metric_match_jax(steps):
    for key in ("loss", "epe2d"):
        got, want = float(steps["metrics"][key]), float(steps["jmetrics"][key])
        assert np.isfinite(got) and np.isfinite(want)
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=key)
    assert steps["state"].step == steps["jstep"] == 1
    assert steps["state"].notfinite_count == 0


def test_train_step_gradients_match_jax_tensor_by_tensor(steps):
    """The port's gradients are read after its clipping, JAX's before: the
    global norms are compared first, then each tensor at the port's scale."""
    named = dict(steps["state"].model.named_parameters())
    jnorm = float(np.sqrt(sum(float((g.double() ** 2).sum())
                              for k, g in steps["jgrads"].items()
                              if k in named)))
    norm = float(steps["metrics"]["grad_norm"])
    np.testing.assert_allclose(norm, jnorm, rtol=1e-3)
    scale = 1.0 / norm if norm > 1.0 else 1.0
    floor = 1e-5 * norm * scale
    worst = 0.0
    for name, p in named.items():
        want = steps["jgrads"][name] * scale
        assert torch.isfinite(p.grad).all(), name
        assert p.grad.shape == want.shape, name
        err = float((p.grad - want).norm() / want.norm().clamp_min(floor))
        assert err <= 2e-2, f"{name}: {err}"
        worst = max(worst, err)
    assert worst > 0.0


def test_train_step_updated_parameters_match_jax(steps):
    lr = rt.onecycle_lr(0)
    n_off = n_all = n_moved = 0
    for name, p in steps["state"].model.named_parameters():
        d = (p.detach() - steps["jparams"][name]).abs()
        assert float(d.max()) <= 2.0 * lr * 1.001, name
        n_off += int((d > 0.01 * lr).sum())
        n_all += d.numel()
        n_moved += int((p.detach() != steps["before"][name]).sum())
    assert n_off <= 0.02 * n_all, n_off / n_all
    # (The heads' gradient clip zeroes entries above 0.01, and a 64x80 image
    # leaves taps of the deepest 3x3 convolutions on padding only: their
    # weights see a zero gradient and only decay.)
    assert n_moved > 0.5 * n_all


def test_train_step_leaves_the_batchnorm_statistics_alone(steps):
    model = steps["state"].model
    assert model.training
    buffers = dict(model.named_buffers())
    assert len(buffers) > 100
    for name, b in buffers.items():
        assert torch.equal(b, steps["before"][name]), name


def test_a_nonfinite_step_is_skipped_and_counted(steps, monkeypatch):
    """A NaN depth poisons the loss: nothing is applied, the skip is
    counted, and more than the limit in a row raise."""
    state = steps["state"]
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    bad = {k: _t(v).clone() for k, v in steps["batch"].items()}
    bad["depth1"][0, 11, 13] = float("nan")
    metrics = rt.train_step(state, bad, iters=1)
    assert not np.isfinite(float(metrics["loss"]))
    assert state.notfinite_count == 1 and state.step == 1
    assert state.calls == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    monkeypatch.setattr(rt, "MAX_CONSECUTIVE_SKIPS", 1)
    with pytest.raises(FloatingPointError, match="consecutive"):
        rt.train_step(state, bad, iters=1)
    good = {k: _t(v) for k, v in steps["batch"].items()}
    metrics = rt.make_train_step(iters=1)(state, good)
    assert np.isfinite(float(metrics["loss"])) and state.notfinite_count == 0


def test_a_skipped_step_moves_neither_the_count_nor_the_schedule(steps):
    """As optax's ``apply_if_finite``: after a skipped update the next one
    is read at the count of the updates applied, and AdamW's own count
    matches it; only ``calls`` counts the skip."""
    state = steps["state"]
    applied, calls = state.step, state.calls
    bad = {k: _t(v).clone() for k, v in steps["batch"].items()}
    bad["depth1"][0, 3, 5] = float("nan")
    rt.train_step(state, bad, iters=1)
    assert state.step == applied and state.calls == calls + 1
    good = {k: _t(v) for k, v in steps["batch"].items()}
    rt.train_step(state, good, iters=1)
    assert state.step == applied + 1 and state.calls == calls + 2
    assert rt.onecycle_lr(applied) != rt.onecycle_lr(applied + 1)
    for group in state.optimizer.param_groups:
        assert group["lr"] == rt.onecycle_lr(applied)
    for moments in state.optimizer.state.values():
        assert int(moments["step"]) == state.step


# ----------------------------------------------------------------------
# Checkpoint
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def saved(steps, tmp_path_factory):
    """The train state of ``steps`` written once: (directory, model path)."""
    ckpt_dir = str(tmp_path_factory.mktemp("raft3d_ckpt"))
    return ckpt_dir, loop.save_raft3d_checkpoint(steps["state"], ckpt_dir)


def test_checkpoint_round_trip_resumes_bit_for_bit(steps, saved):
    """Model, optimizer moments and counters come back bit for bit, and the
    next step of the restored state is the next step of the saved one: the
    same loss exactly, the same parameters to 2 learning rates (the
    lookup's scatter-add backward sums in an order that changes from run to
    run, so the gradients of the feature encoder differ in their last
    bits)."""
    state = steps["state"]
    batch = {k: _t(v) for k, v in steps["batch"].items()}
    ckpt_dir, path = saved
    assert path.endswith("raft3d.pth")
    fresh = rt.create_train_state(device="cpu", seed=5)
    loop.restore_raft3d_checkpoint(fresh, ckpt_dir)
    assert fresh.step == state.step and fresh.calls == state.calls
    assert fresh.notfinite_count == state.notfinite_count
    for (n, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    kept = state.optimizer.state_dict()["state"]
    loaded = fresh.optimizer.state_dict()["state"]
    assert len(kept) == len(loaded) > 200
    for k, moments in kept.items():
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(moments[name], loaded[k][name]), (k, name)
    m1 = rt.train_step(state, batch, iters=1)
    m2 = rt.train_step(fresh, batch, iters=1)
    assert float(m1["loss"]) == float(m2["loss"])
    lr = rt.onecycle_lr(state.step - 1)
    for (n, a), b in zip(state.model.named_parameters(),
                         fresh.model.parameters()):
        assert float((a - b).detach().abs().max()) <= 2.0 * lr * 1.001, n


def test_the_trained_checkpoint_serves_through_the_submission_loader(
        steps, saved):
    """``raft3d.pth`` is a bare state dict of the model: what
    ``kitti_submission --ckpt_dir`` loads. (Read before the round-trip test
    above steps the saved state on: the file holds the state as saved.)"""
    from sndepth_tpu_torch.cli.kitti_submission import load_raft3d_checkpoint
    served = traft.RAFT3D().eval()
    load_raft3d_checkpoint(served, saved[1])
    want = torch.load(saved[1], map_location="cpu", weights_only=True)
    assert set(want) == set(served.state_dict())
    for n, a in served.state_dict().items():
        assert torch.equal(a, want[n]), n
    bt = steps["batch"]
    frame = [_t(to_nchw(bt["image1"])), _t(to_nchw(bt["image2"])),
             _t(bt["depth1"]), _t(bt["depth2"]), _t(bt["intrinsics"])]
    with torch.no_grad():
        Ts = served(*frame, iters=2)
    assert Ts.shape == (1, H, W, 7) and torch.isfinite(Ts).all()
