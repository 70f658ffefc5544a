"""The port's NNET training against ``sndepth_tpu`` on the CPU, on the same
inputs and weights, made from a seed with numpy: BatchNorm in train mode
against the JAX package's ``BatchNorm`` and flax's ``nn.BatchNorm``, the
angular NLL at its clip, the multi-scale decoder loss in both forms, the
point sampler, the decoder's dense and gather train forms against each
other, AdamW against optax, and one train step against the JAX
``train_step``.

The train step runs the encoder at 64x96 with one block a stage
(``tests/test_torch_nnet.py``'s plan) and the decoder at its fixed widths;
JAX parameters come from ``jax.eval_shape`` of ``init`` and numpy and reach
the port through ``normalnet_state_dict_from_jax``. The JAX step is jitted
once. Its sampler draws the coverage points with ``jax.random``, which
torch cannot reproduce: the test records the JAX draw (a wrapper around the
JAX ``sample_points`` inside the jitted step) and hands it to the port's
decoder through a stand-in for the port's ``sample_points``. The JAX step's
gradients come out through a wrapper around its optimizer that carries
them in its state (the update is optax's, unchanged).

Tolerances. BatchNorm in train mode: outputs and gradients 1e-4 relative
by norm, both running statistics within 1e-5 (a channel where the fast and
the two-pass variance part included). The angular NLL
and the decoder loss rtol 1e-5 on values, 1e-4 relative by norm on
gradients. The sampler: the importance set and the counts equal to JAX's.
The two decoder forms 1e-6 by norm (the same pointwise products). AdamW on
given gradients atol 1e-9 + rtol 2e-6 of a parameter over three updates.
The train step: loss rtol 1e-4; each tensor's gradient within 2e-2 of the
port's float64 evaluation of the step and within 5e-2 of JAX's (the norm
floored at 1e-5 of the global norm; JAX's own float32 gradients part from
float64 by up to 2.9% here); after the update no
entry more than 2 learning rates from JAX's and at most 2% more than a
hundredth of a rate off (the first Adam update is the rate times the
gradient's sign); the running statistics within 1e-5. Every gradient is
asserted finite.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from sndepth_tpu.losses import normal_loss as jloss
from sndepth_tpu.models import efficientnet as jeff
from sndepth_tpu.models import normal_decoder as jdec
from sndepth_tpu.ops import norm as jnorm
from sndepth_tpu.train import nnet as jtn
from sndepth_tpu_torch.losses import normal_loss as tloss
from sndepth_tpu_torch.models import nnet as tnnet
from sndepth_tpu_torch.models import normal_decoder as tdec
from sndepth_tpu_torch.ops.norm import BatchNorm2d
from sndepth_tpu_torch.train import nnet as tn
from sndepth_tpu_torch.utils.threads import torch_threads
from sndepth_tpu_torch.utils.weights import normalnet_state_dict_from_jax
from test_torch_nnet import BLOCKS, HEAD, STEM, TBLOCKS


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


B, H, W = 2, 64, 96
TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    """Relative error by norm, after asserting shapes and finiteness."""
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# --- BatchNorm in train mode -------------------------------------------------

@pytest.mark.parametrize("flax_cls,eps", [
    (jnorm.BatchNorm, 1e-3), (fnn.BatchNorm, 1e-5)],
    ids=["sndepth_tpu_BatchNorm", "flax_BatchNorm"])
def test_batchnorm_train_mode_matches_flax(flax_cls, eps):
    """Output, the gradients of the input, the scale and the bias under a
    random cotangent, and both running statistics after two steps, from
    running statistics away from their initial values.

    Channel 0 holds 64 + k/8 for small integers k (mean 64, spread ~0.3),
    32 values a channel: every sum is exact in float32, so flax's fast
    variance E[x^2] - E[x]^2 is the same number on both sides and differs
    from the two-pass variance of ``F.batch_norm`` by the rounding of
    E[x]^2; there the port's output matches flax's and torch's own does
    not."""
    rng = np.random.RandomState(0)
    c = 6
    xs = [rng.randn(2, 4, 4, c).astype(np.float32) for _ in range(2)]
    for x in xs:
        x[..., 0] = 64.0 + rng.randint(-4, 5, x.shape[:-1]) / 8.0
    scale = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    mean0 = (0.1 * rng.randn(c)).astype(np.float32)
    var0 = (0.5 + rng.rand(c)).astype(np.float32)
    cot = rng.randn(*xs[0].shape).astype(np.float32)
    bn = flax_cls(use_running_average=False, epsilon=eps)

    @jax.jit
    def forward_and_vjp(params, stats, x):
        (out, mut), vjp = jax.vjp(lambda p, xx: bn.apply(
            {"params": p, "batch_stats": stats}, xx,
            mutable=["batch_stats"]), params, x)
        return out, mut["batch_stats"], vjp((jnp.asarray(cot), jax.tree_util.
                                             tree_map(jnp.zeros_like, mut)))

    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    port = BatchNorm2d(c, eps=eps).train()
    with torch.no_grad():
        port.weight.copy_(_t(scale))
        port.bias.copy_(_t(bias))
        port.running_mean.copy_(_t(mean0))
        port.running_var.copy_(_t(var0))
    for x in xs:
        out, stats, (gp, gx) = forward_and_vjp(params, stats, jnp.asarray(x))
        xt = _t(x).permute(0, 3, 1, 2).requires_grad_(True)
        got = port(xt)
        (got * _t(cot).permute(0, 3, 1, 2)).sum().backward()
        assert _rel(got.permute(0, 2, 3, 1), out) <= TOL
        assert _rel(got[:, 0], np.asarray(out)[..., 0]) <= 1e-6
        assert _rel(xt.grad.permute(0, 2, 3, 1), gx) <= TOL
        for g, w in ((port.weight.grad, gp["scale"]),
                     (port.bias.grad, gp["bias"])):
            assert torch.isfinite(g).all()
            assert _rel(g, w) <= TOL
        port.weight.grad = port.bias.grad = None
        np.testing.assert_allclose(port.running_mean.numpy(),
                                   np.asarray(stats["mean"]), atol=1e-5)
        np.testing.assert_allclose(port.running_var.numpy(),
                                   np.asarray(stats["var"]), atol=1e-5)
    two_pass = F.batch_norm(_t(xs[-1]).permute(0, 3, 1, 2), None, None,
                            _t(scale), _t(bias), True, 0.0, eps)
    assert _rel(two_pass[:, 0], np.asarray(out)[..., 0]) > 1e-4


def test_batchnorm_eval_mode_and_dtype():
    """Eval mode normalises with the running statistics; the output takes
    ``dtype`` in both modes, the statistics stay float32."""
    rng = np.random.RandomState(1)
    x = _t(rng.randn(2, 4, 5, 6).astype(np.float32))
    bn = BatchNorm2d(4, dtype=torch.bfloat16)
    with torch.no_grad():
        bn.running_mean.copy_(_t(rng.randn(4).astype(np.float32)))
        bn.running_var.copy_(_t(0.5 + rng.rand(4).astype(np.float32)))
    with torch.no_grad():
        want = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    got = bn.eval()(x.bfloat16())
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), want) <= 1e-2
    out = bn.train()(x.bfloat16())
    assert out.dtype == torch.bfloat16
    assert bn.running_mean.dtype == torch.float32
    assert int(bn.num_batches_tracked) == 1


# --- losses ------------------------------------------------------------------

def test_angular_nll_matches_jax_at_the_clip():
    """Cosines exactly at +-(1 - 1e-7) in float32, beyond them (parallel
    and opposite normals), and inside; with and without a mask. At the clip
    JAX's min/max pass half the gradient, and so does the port."""
    c = np.float32(1.0 - 1e-7)
    rng = np.random.RandomState(2)
    n = rng.randn(40, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    gt = rng.randn(40, 3).astype(np.float32)
    gt /= np.linalg.norm(gt, axis=-1, keepdims=True)
    e = np.array([1, 0, 0], np.float32)
    n[:4] = [c * e, -c * e, e, -e]
    gt[:4] = e
    kappa = (0.5 + 3 * rng.rand(40, 1)).astype(np.float32)
    pred = np.concatenate([n, kappa], -1)
    dots = (pred[:4, :3] * gt[:4]).sum(-1)
    assert dots[0] == c and dots[1] == -c
    mask = (rng.rand(40) > 0.3).astype(np.float32)
    for m in (None, mask):
        want, grad = jax.value_and_grad(lambda p: jloss.angular_nll(
            p, jnp.asarray(gt), None if m is None else jnp.asarray(m)))(
                jnp.asarray(pred))
        pt = _t(pred).requires_grad_(True)
        got = tloss.angular_nll(pt, _t(gt), None if m is None else _t(m))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
        assert _rel(pt.grad, grad) <= TOL
        assert float(pt.grad[2, 0]) == 0.0          # beyond the clip


def _decoder_case(seed, gather):
    """Random decoder outputs at four levels of a 32x48 image, their
    refined points (dense maps or gathered points) and selections, unit
    normals and a mask."""
    rng = np.random.RandomState(seed)
    sizes = [(4, 6), (8, 12), (16, 24), (32, 48)]

    def unit_kappa(*shape):
        a = rng.randn(*shape, 4).astype(np.float32)
        a[..., :3] /= np.linalg.norm(a[..., :3], axis=-1, keepdims=True)
        a[..., 3] = 0.1 + 2 * np.abs(a[..., 3])
        return a

    outs = [unit_kappa(B, h, w) for h, w in sizes]
    preds, idx = [outs[0]], [None]
    for h, w in sizes[1:]:
        n = int(0.4 * h * w)
        flat = np.stack([rng.permutation(h * w)[:n] for _ in range(B)])
        rows, cols = flat // w, flat % w
        if gather:
            preds.append(unit_kappa(B, n))
            idx.append((rows.astype(np.int32), cols.astype(np.int32)))
        else:
            preds.append(unit_kappa(B, h, w))
            sel = np.zeros((B, h * w), np.float32)
            np.put_along_axis(sel, flat, 1.0, 1)
            idx.append(sel.reshape(B, h, w))
    gt = rng.randn(B, 32, 48, 3).astype(np.float32)
    gt /= np.linalg.norm(gt, axis=-1, keepdims=True)
    mask = rng.rand(B, 32, 48) > 0.25
    return outs, preds, idx, gt, mask


@pytest.mark.parametrize("gather", [False, True], ids=["dense", "gather"])
def test_decoder_multi_scale_loss_matches_jax(gather):
    """Value and the gradients of every map and every level's points, with
    and without the mask."""
    outs, preds, idx, gt, mask = _decoder_case(3, gather)

    def jidx(i):
        return i if i is None or not isinstance(i, tuple) else tuple(
            map(jnp.asarray, i))

    for m in (mask, None):
        def jfn(o, p):
            return jloss.decoder_multi_scale_loss(
                o, [p[0]] + p[1:], [jidx(i) for i in idx], jnp.asarray(gt),
                None if m is None else jnp.asarray(m))

        want, (go, gp) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
            [jnp.asarray(o) for o in outs], [jnp.asarray(p) for p in preds])
        to = [_t(o).requires_grad_(True) for o in outs]
        tp = [_t(p).requires_grad_(True) for p in preds]
        tidx = [None] + [tuple(_t(a).long() for a in i) if gather else _t(i)
                         for i in idx[1:]]
        got = tloss.decoder_multi_scale_loss(
            to, tp, tidx, _t(gt), None if m is None else _t(m))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
        for g, w in zip([t.grad for t in to + tp], list(go) + list(gp)):
            if g is None:
                assert float(jnp.abs(w).max()) == 0.0
            else:
                assert _rel(g, w) <= TOL


# --- the sampler -------------------------------------------------------------

@pytest.mark.parametrize("case", ["kappa", "masked_ties"])
def test_sample_points_importance_set_matches_jax(case):
    """The importance set and the counts of the "exact" backend, on a kappa
    map with repeated values and, with a mask (nearest-resized from 2x the
    size), many pixels tied at -1e4; the coverage points are unique, drawn
    from the rest, N - int(0.7 N) of them."""
    rng = np.random.RandomState(4)
    h, w = 12, 20
    init = rng.randn(B, h, w, 4).astype(np.float32)
    init[..., 3] = np.round(rng.rand(B, h, w) * 8) / 4    # ties
    mask = None
    if case == "masked_ties":
        mask = (rng.rand(B, 2 * h, 2 * w, 1) > 0.4)
    n = int(0.4 * h * w)
    n_imp = int(0.7 * n)
    jrows, jcols = jax.jit(lambda i, m: jdec.sample_points(
        jax.random.PRNGKey(0), i, m, 0.4, 0.7))(
            jnp.asarray(init), None if mask is None else jnp.asarray(mask))
    rows, cols = tdec.sample_points(
        _t(init), None if mask is None else _t(mask),
        torch.Generator().manual_seed(0))
    assert rows.shape == cols.shape == (B, n) == jrows.shape
    np.testing.assert_array_equal(rows[:, :n_imp].numpy(), jrows[:, :n_imp])
    np.testing.assert_array_equal(cols[:, :n_imp].numpy(), jcols[:, :n_imp])
    flat = (rows * w + cols).numpy()
    for b in range(B):
        assert len(set(flat[b])) == n                 # unique
        assert set(flat[b, n_imp:]).isdisjoint(flat[b, :n_imp])
    assert (rows >= 0).all() and (rows < h).all()
    assert (cols >= 0).all() and (cols < w).all()


def test_selection_gather_and_scatter_match_jax():
    rng = np.random.RandomState(5)
    h, w, n = 6, 9, 20
    flat = np.stack([rng.permutation(h * w)[:n] for _ in range(B)])
    rows, cols = flat // w, flat % w
    feat = rng.randn(B, h, w, 3).astype(np.float32)
    vals = rng.randn(B, n, 3).astype(np.float32)
    jr, jc = jnp.asarray(rows), jnp.asarray(cols)
    tr, tc = _t(rows), _t(cols)
    np.testing.assert_array_equal(
        tdec.selection_mask(tr, tc, h, w).numpy(),
        np.asarray(jdec.selection_mask(jr, jc, h, w)))
    np.testing.assert_array_equal(
        tdec.gather_points(_t(feat), tr, tc).numpy(),
        np.asarray(jdec.gather_points(jnp.asarray(feat), jr, jc)))
    np.testing.assert_array_equal(
        tdec.scatter_points(_t(feat), tr, tc, _t(vals)).numpy(),
        np.asarray(jdec.scatter_points(jnp.asarray(feat), jr, jc,
                                       jnp.asarray(vals))))


@pytest.fixture(scope="module")
def small_net():
    """The port's NormalNet at the test plan, random weights from seed 3."""
    net = tn.NormalNet(blocks=TBLOCKS, stem_ch=STEM, head_ch=HEAD)
    tnnet.init_weights(net, torch.Generator().manual_seed(3))
    return net


def test_dense_refine_and_gather_forms_agree(small_net):
    """The decoder's two train forms on the same draw: the same maps, and
    the same loss through both forms of ``decoder_multi_scale_loss``."""
    rng = np.random.RandomState(6)
    rgb = _t(rng.rand(1, H, W, 3).astype(np.float32))
    normals = rng.randn(1, H, W, 3).astype(np.float32)
    normals = _t(normals / np.linalg.norm(normals, axis=-1, keepdims=True))
    mask = _t(rng.rand(1, H, W) > 0.2)
    results = []
    with torch.no_grad():
        for dense in (True, False):
            outs, pts, sel = small_net.train()(
                rgb, "train", gt_norm_mask=mask[..., None],
                generator=torch.Generator().manual_seed(7),
                dense_refine=dense)
            results.append((outs, tloss.decoder_multi_scale_loss(
                outs, pts, sel, normals, mask)))
    (outs_d, loss_d), (outs_g, loss_g) = results
    for a, b in zip(outs_d, outs_g):
        assert _rel(a, b) <= 1e-6
    np.testing.assert_allclose(float(loss_d), float(loss_g), rtol=1e-6)


# --- AdamW -------------------------------------------------------------------

def test_three_adamw_updates_match_optax():
    """``make_optimizer()`` (AdamW 3.57e-4, decay 1e-3 on every parameter)
    against the port's ``torch.optim.AdamW`` on the same three gradients."""
    rng = np.random.RandomState(8)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    tx = jtn.make_optimizer()
    opt_state = tx.init(params)
    tparams = [torch.nn.Parameter(_t(a).clone())
               for a in jax.tree_util.tree_leaves(params)]
    opt = tn.make_optimizer(tparams)
    update = jax.jit(tx.update)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.randn(*a.shape).astype(np.float32), params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for p, g in zip(tparams, jax.tree_util.tree_leaves(grads)):
            p.grad = _t(g).clone()
        opt.step()
    for p, want in zip(tparams, jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   atol=1e-9, rtol=2e-6)


# --- one train step against the JAX package's --------------------------------

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


def _fill(shapes, seed):
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        keys = [p.key for p in path]
        name = keys[-1]
        if name == "kernel":
            a = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "var":
            a = 0.5 + rng.rand(*leaf.shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.randn(*leaf.shape)
        else:                                    # bias, mean
            a = 0.1 * rng.randn(*leaf.shape)
        if "NormalDecoder_0" in keys and keys[-2:] in (["Conv_1", "bias"],
                                                       ["Dense_3", "bias"]):
            a[2] += 3.0                          # normals face the camera
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def steps():
    """One train step on both sides from the same weights, batch and draw;
    the JAX ``train_step`` jitted once."""
    rng = np.random.RandomState(9)
    n = rng.randn(B, H, W, 3).astype(np.float32)
    batch = {"rgb": rng.rand(B, H, W, 3).astype(np.float32),
             "normals": n / np.linalg.norm(n, axis=-1, keepdims=True),
             "mask": rng.rand(B, H, W) > 0.2}
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    drawn = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtn, "EfficientNetEncoder", functools.partial(
            jeff.EfficientNetEncoder, blocks=BLOCKS, stem_ch=STEM,
            head_ch=HEAD))
        mp.setattr(jtn, "make_optimizer",
                   _carrying_optimizer(jtn.make_optimizer))
        real_sample = jdec.sample_points

        def recording(*args):
            out = real_sample(*args)
            drawn.append(out)
            return out

        mp.setattr(jdec, "sample_points", recording)
        shapes = jax.eval_shape(lambda k: jtn.NormalNet().init(
            k, jbatch["rgb"], mode="test"), jax.random.PRNGKey(0))
        v = _fill(shapes, 10)
        params, stats = v["params"], v["batch_stats"]
        state = jtn.NormalTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=jtn.make_optimizer().init(params),
            rng=jax.random.PRNGKey(1))

        @jax.jit
        def jax_step(st):
            drawn.clear()
            new, metrics = jtn.train_step(st, jbatch)
            return new, metrics, list(drawn)

        jnew, jmetrics, jdraw = jax.device_get(jax_step(state))

    sd = normalnet_state_dict_from_jax(params, stats)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        model = tn.NormalNet(dtype, blocks=TBLOCKS, stem_ch=STEM,
                             head_ch=HEAD)
        model.load_state_dict(sd)
        tstate = tn.create_train_state(model.to(dtype), "cpu")
        handed = iter(jdraw)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tdec, "sample_points", lambda *a: tuple(
                _t(x).long() for x in next(handed)))
            metrics = tn.train_step(tstate, {
                k: _t(a).to(dtype) if a.dtype == np.float32 else _t(a)
                for k, a in batch.items()})
        assert next(handed, None) is None
        runs[dtype] = tstate, metrics
    to_sd = normalnet_state_dict_from_jax
    (tstate, metrics), (state64, _) = runs[torch.float32], runs[torch.float64]
    return {"jgrads": to_sd(jnew.opt_state[1], stats),
            "jnew": to_sd(jnew.params, jnew.batch_stats),
            "jmetrics": jmetrics, "state": tstate, "metrics": metrics,
            "grads64": {n: p.grad
                        for n, p in state64.model.named_parameters()},
            "draw": jdraw, "init": (params, stats)}


def test_train_step_loss_matches_jax(steps):
    got, want = float(steps["metrics"]["loss"]), float(steps["jmetrics"][
        "loss"])
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert steps["state"].step == 1
    assert [r.shape for r, _ in steps["draw"]] == [
        (B, int(0.4 * (H // 4) * (W // 4))),
        (B, int(0.4 * (H // 2) * (W // 2))),
        (B, int(0.4 * H * W))]


def test_train_step_gradients_match_jax_tensor_by_tensor(steps):
    """Each tensor's gradient, the norm floored at 1e-5 of the global norm:
    the port's within 2e-2 of the port's float64 evaluation of the same
    step, and the port's and JAX's float32 ones within 5e-2 of each other
    and of that float64 one. Train-mode BatchNorm and squeeze-excitation
    through the encoder make float32 gradients ill-conditioned here: JAX's
    parts from the float64 evaluation by up to 2.9% on a tensor (1.2%
    median), the port's by up to 1.4% (0.7% median)."""
    named = dict(steps["state"].model.named_parameters())
    g64 = steps["grads64"]
    norm = float(np.sqrt(sum(float((g ** 2).sum()) for g in g64.values())))

    def err(got, want):
        return float((got.double() - want.double()).norm()
                     / want.double().norm().clamp_min(1e-5 * norm))

    worst = 0.0
    for name, p in named.items():
        want = steps["jgrads"][name]
        assert torch.isfinite(p.grad).all(), name
        assert torch.isfinite(g64[name]).all(), name
        assert err(p.grad, g64[name]) <= 2e-2, name
        assert err(want, g64[name]) <= 5e-2, name
        e = err(p.grad, want)
        assert e <= 5e-2, f"{name}: {e}"
        worst = max(worst, e)
    assert worst > 0.0


def test_train_step_updated_parameters_match_jax(steps):
    lr = tn.LR
    n_off = n_all = 0
    before = normalnet_state_dict_from_jax(*steps["init"])
    for name, p in steps["state"].model.named_parameters():
        d = (p.detach() - steps["jnew"][name]).abs()
        assert float(d.max()) <= 2.0 * lr * 1.001, name
        n_off += int((d > 0.01 * lr).sum())
        n_all += d.numel()
        assert not torch.equal(p.detach(), before[name]), name
    assert n_off <= 0.02 * n_all, n_off / n_all


def test_train_step_carries_the_batch_statistics(steps):
    before = normalnet_state_dict_from_jax(*steps["init"])
    moved = 0
    for name, buf in steps["state"].model.named_buffers():
        if "running" not in name:
            continue
        np.testing.assert_allclose(buf.numpy(), steps["jnew"][name].numpy(),
                                   atol=1e-5, err_msg=name)
        moved += not torch.equal(buf, before[name])
    assert moved > 20
