"""The port's UniAD tracker training against the JAX package on the CPU:
the auction assignment round for round (and against scipy's optimum), the
focal and L1 costs and losses, the frame matcher with pinned slots, the
per-layer ClipMatcher losses with the ego slot and the binding of new
tracks, the MOTR clip loss, the trainer's QIM selection with its draws
handed across, the memory bank in train mode, the synthetic clip, AdamW
after the global-norm clip, one whole 3-frame train step of the small
config (on the synthetic clip, where the QIM keeps no slot, and on a clip
whose GTs sit on the model's own detections, where it keeps slots in
every frame and the QIM and memory bank reach the loss) and the
``train_uniad`` CLI.

JAX parameters come from ``jax.eval_shape`` and numpy as in
``tests/test_torch_uniad.py``; the train step's QIM keys are the test's
(the JAX ``qim_select_train`` is handed a key of each frame by a wrapper),
their uniform draws handed to the port.

Tolerances: the costs and losses rtol 1e-5; assignments, bindings and
selections equal; the train step's loss rtol 1e-5, each tensor's gradient
within 1e-4 of JAX's by norm (floored at 1e-5 of the global norm; measured
up to 6e-6), every gradient finite; after AdamW no weight more than 2
learning rates from JAX's and at most 1e-3 of them more than a hundredth of
a rate off (Adam's first update is the rate times a gradient's sign, which
float noise decides where the gradient is zero, as for the key projection's
bias); AdamW on given gradients atol 1e-9 + rtol 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from sndepth_tpu.losses import lap as jlap
from sndepth_tpu.losses import track_loss as jtl
from sndepth_tpu.models import track_runtime as jtr
from sndepth_tpu.models import uniad_track as jua
from sndepth_tpu.train import uniad as jtu
from sndepth_tpu_torch.cli import train_uniad
from sndepth_tpu_torch.losses import lap as tlap
from sndepth_tpu_torch.losses import track_loss as ttl
from sndepth_tpu_torch.models import track_runtime as ttr
from sndepth_tpu_torch.models import uniad_track as tua
from sndepth_tpu_torch.train import loop
from sndepth_tpu_torch.train import uniad as ttu
from sndepth_tpu_torch.utils import weights as tw
from sndepth_tpu_torch.utils.threads import torch_threads
from test_torch_uniad import (BLOCKS, _check, _check_tracks, _fill,
                              _jax_tracks, _params, _to_port)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _gt(rng, ng, nc, steps=5, sdc=False):
    gt = {"labels": rng.randint(0, nc, ng),
          "boxes": rng.randn(ng, 10).astype(np.float32),
          "valid": rng.rand(ng) > 0.2,
          "instance_ids": rng.permutation(20)[:ng],
          "past_traj": rng.randn(ng, steps, 2).astype(np.float32),
          "past_traj_mask": (rng.rand(ng, steps, 2) > 0.3).astype(
              np.float32)}
    if sdc:
        gt["sdc_label"] = np.asarray(rng.randint(0, nc))
        gt["sdc_box"] = rng.randn(10).astype(np.float32)
    return gt


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: _t(v) for k, v in d.items()}


# ----------------------------------------------------------------------
# The auction
# ----------------------------------------------------------------------

@pytest.mark.parametrize("nq,ng,seed,kind", [
    (6, 4, 0, "uniform"), (32, 10, 1, "uniform"), (16, 16, 3, "uniform"),
    (901, 40, 2, "uniform"), (12, 8, 4, "ties"), (10, 6, 5, "forbidden"),
    (3, 5, 6, "uniform")])
def test_auction_matches_jax_round_for_round(nq, ng, seed, kind):
    """The same rows as JAX's auction, also with integer costs (ties
    everywhere: the lowest index wins), with forbidden (1e9) rows, and
    with more valid columns than rows; the cost within ng eps of scipy's
    optimum."""
    rng = np.random.RandomState(seed)
    cost = (rng.rand(nq, ng) * 20).astype(np.float32)
    if kind == "ties":
        cost = np.floor(cost / 5).astype(np.float32)
    if kind == "forbidden":
        cost[rng.rand(nq) > 0.6] = 1e9
    valid = rng.rand(ng) > 0.25
    valid[0] = True
    want = np.asarray(jax.jit(jlap.auction_lap)(jnp.asarray(cost),
                                                jnp.asarray(valid)))
    got = tlap.auction_lap(_t(cost), _t(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    rows = got.numpy()
    cols = np.nonzero(rows >= 0)[0]
    if nq >= valid.sum() and kind != "forbidden":
        idx = np.nonzero(valid)[0]
        r, c = linear_sum_assignment(cost[:, idx])
        opt = float(cost[r, idx[c]].sum())
        span = float(cost.max() - cost.min())
        assert float(cost[rows[cols], cols].sum()) <= opt + ng * span * 1e-5
        assert len(set(rows[cols])) == len(cols)


# ----------------------------------------------------------------------
# Costs, matching, losses
# ----------------------------------------------------------------------

def test_costs_and_focal_loss_match_jax():
    rng = np.random.RandomState(7)
    logits = (rng.randn(9, 4) * 3).astype(np.float32)
    targets = (rng.rand(9, 4) > 0.7).astype(np.float32)
    labels = rng.randint(0, 4, 5)
    boxes, gtb = rng.randn(9, 10).astype(np.float32), rng.randn(
        5, 10).astype(np.float32)
    _check(ttl.sigmoid_focal_loss(_t(logits), _t(targets)),
           jax.jit(jtl.sigmoid_focal_loss)(jnp.asarray(logits),
                                           jnp.asarray(targets)),
           rtol=1e-5, atol=1e-7)
    _check(ttl.focal_cls_cost(_t(logits), _t(labels)),
           jax.jit(jtl.focal_cls_cost)(jnp.asarray(logits),
                                       jnp.asarray(labels)),
           rtol=1e-5, atol=1e-7)
    _check(ttl.l1_bbox_cost(_t(boxes), _t(gtb)),
           jax.jit(jtl.l1_bbox_cost)(jnp.asarray(boxes), jnp.asarray(gtb)),
           rtol=1e-6)


@pytest.mark.parametrize("pinned", [[-1, -1, -1, -1], [0, -1, 3, -1],
                                    [-1, 0, -1, 2]])
def test_match_frame_and_frame_losses_match_jax(pinned):
    """Pinned GTs keep their slots; the unpinned all clamp onto slot 0 in
    the JAX scatter, whose last write stays: a GT pinned to slot 0 before an
    unpinned one leaves slot 0 in the auction, as in JAX."""
    rng = np.random.RandomState(8)
    logits = rng.randn(10, 3).astype(np.float32)
    boxes = rng.randn(10, 10).astype(np.float32)
    gt = _gt(rng, 4, 3)
    exclude = rng.rand(10) > 0.8
    pin = np.asarray(pinned, np.int32)
    args = (logits, boxes, gt["labels"], gt["boxes"], gt["valid"], pin)
    want_a, want_m = jax.jit(jtl.match_frame)(
        *map(jnp.asarray, args), exclude_query=jnp.asarray(exclude))
    got_a, got_m = ttl.match_frame(*map(_t, args), exclude_query=_t(exclude))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    want = jax.jit(lambda *a: jtl.frame_losses(
        *a, 3, code_weights=jtl.CODE_WEIGHTS_10, sdc_slot=9,
        sdc_label=jnp.asarray(1), sdc_box=a[1][2]))(
        jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(gt["labels"]),
        jnp.asarray(gt["boxes"]), jnp.asarray(gt["valid"]), want_a, want_m)
    got = ttl.frame_losses(_t(logits), _t(boxes), _t(gt["labels"]),
                           _t(gt["boxes"]), _t(gt["valid"]), got_a, got_m, 3,
                           code_weights=ttl.CODE_WEIGHTS_10, sdc_slot=9,
                           sdc_label=torch.tensor(1), sdc_box=_t(boxes[2]))
    for k in want:
        _check(got[k], want[k], rtol=1e-5)
    traj = rng.randn(10, 5, 2).astype(np.float32)
    _check(ttl.past_traj_loss(_t(traj), _t(gt["past_traj"]),
                              _t(gt["past_traj_mask"]), got_a, got_m),
           jax.jit(jtl.past_traj_loss)(
               jnp.asarray(traj), jnp.asarray(gt["past_traj"]),
               jnp.asarray(gt["past_traj_mask"]), want_a, want_m),
           rtol=1e-5)


def test_clip_matcher_loss_matches_jax():
    rng = np.random.RandomState(9)
    outs, gts = [], []
    for t in range(3):
        obj = np.full(8, -1, np.int32)
        obj[[0, 4]] = [7, 11]
        outs.append({"logits": rng.randn(8, 5).astype(np.float32),
                     "boxes": rng.randn(8, 10).astype(np.float32),
                     "obj_idxes": obj})
        gts.append({"labels": rng.randint(0, 5, 3),
                     "boxes": rng.randn(3, 10).astype(np.float32),
                     "valid": np.array([True, True, t != 1]),
                     "instance_ids": np.array([7, 11, 3])})
    want = jax.jit(lambda o, g: jtl.clip_matcher_loss(o, g, num_classes=5))(
        [_jnp(o) for o in outs], [_jnp(g) for g in gts])
    got = ttl.clip_matcher_loss([_torch(o) for o in outs],
                                [_torch(g) for g in gts], num_classes=5)
    for k in want:
        _check(got[k], want[k], rtol=1e-5)


@pytest.mark.parametrize("seed", [10, 11])
def test_train_frame_layer_losses_match_jax(seed):
    """Three decoder layers, tracked slots (pinned), a reserved slot (-2),
    a track whose object left the frame, the ego slot: the summed losses,
    the new bindings and the last layer's matching."""
    rng = np.random.RandomState(seed)
    L, nq, ng, nc = 3, 12, 4, 3
    logits = rng.randn(L, nq, nc).astype(np.float32)
    boxes = rng.randn(L, nq, 10).astype(np.float32)
    trajs = rng.randn(L, nq, 5, 2).astype(np.float32)
    gt = _gt(rng, ng, nc, sdc=True)
    obj = np.full(nq, -1, np.int32)
    obj[2] = gt["instance_ids"][1]          # tracked: pinned to slot 2
    obj[5] = 99                              # its object left the frame
    obj[7] = -2                              # reserved
    want, w_obj, w_a, w_m = jax.jit(
        jtl.train_frame_layer_losses, static_argnums=5,
        static_argnames="sdc_slot")(
        jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(trajs),
        jnp.asarray(obj), _jnp(gt), nc, sdc_slot=nq - 1)
    got, g_obj, g_a, g_m = ttl.train_frame_layer_losses(
        _t(logits), _t(boxes), _t(trajs), _t(obj), _torch(gt), nc,
        sdc_slot=nq - 1)
    for k in want:
        _check(got[k], want[k], rtol=1e-5)
    for g, w in ((g_obj, w_obj), (g_a, w_a), (g_m, w_m)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_qim_select_train_matches_jax_with_handed_draws():
    rng = np.random.RandomState(12)
    tracks = _jax_tracks(16, 8, 3, 2, rng).replace(
        iou=jnp.asarray(rng.rand(16), jnp.float32))
    for seed, drop, fp in ((0, 0.1, 0.3), (1, 0.0, 1.0), (2, 1.0, 1.0)):
        key = jax.random.PRNGKey(seed)
        want = jax.jit(lambda t, k: jtr.qim_select_train(
            t, k, random_drop=drop, fp_ratio=fp))(tracks, key)
        k_drop, k_fp = jax.random.split(key)
        draws = (_t(jax.random.uniform(k_drop, (16,))),
                 _t(jax.random.uniform(k_fp, (16,))))
        got = ttr.qim_select_train(_to_port(tracks), *draws,
                                   random_drop=drop, fp_ratio=fp)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_memory_bank_train_mode_matches_jax():
    """``MemoryBank(train=True)``: every scoring slot saves, the cooldown
    untouched."""
    rng = np.random.RandomState(13)
    tracks = _jax_tracks(9, 16, 3, 3, rng)
    tracks = tracks.replace(scores=jnp.asarray(
        np.where(rng.rand(9) > 0.5, rng.rand(9), 0.0), jnp.float32))
    mb = jtr.MemoryBank(embed_dims=16, mem_len=3, train=True)
    p = _params(mb, tracks, seed=14)
    want = jax.jit(lambda pp, t: mb.apply({"params": pp}, t))(p, tracks)
    port = ttr.MemoryBank(16, 3, train=True)
    sd = {}
    tw._dense(sd, "save_proj", p["save_proj"])
    tw._mha(sd, "temporal_attn", p["temporal_attn"])
    for n in ("temporal_fc1", "temporal_fc2"):
        tw._dense(sd, n, p[n])
    for n in ("temporal_norm1", "temporal_norm2"):
        tw._norm(sd, n, p[n])
    port.load_state_dict(sd)
    _check_tracks(port(_to_port(tracks)), want, atol=2e-5, rtol=1e-5)


# ----------------------------------------------------------------------
# The clip, the optimizer, one train step
# ----------------------------------------------------------------------

SMALL_TRAIN = dict(num_query=12, num_classes=3, embed_dims=32, bev_h=4,
                   bev_w=4, num_cams=2, encoder_layers=1, decoder_layers=2,
                   backbone_blocks=(1, 1, 1, 1), mem_len=2)


def test_synthetic_clip_is_bit_equal_to_jax():
    jm = jua.UniADTrack(**SMALL_TRAIN)
    want = jtu.synthetic_clip(jm, t_frames=3, ng=4, img_hw=(16, 24), seed=3)
    got = ttu.synthetic_clip(tua.UniADTrack(**SMALL_TRAIN), t_frames=3, ng=4,
                             img_hw=(16, 24), seed=3)
    np.testing.assert_array_equal(got["imgs_seq"].numpy(), np.moveaxis(
        np.asarray(want["imgs_seq"]), -1, -3))
    for k in ("lidar2img", "timestamps"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert set(got["gt"]) == set(want["gt"])
    for k, v in want["gt"].items():
        np.testing.assert_array_equal(got["gt"][k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_adamw_after_the_clip_matches_optax():
    """Three updates of ``clip_by_global_norm(35)`` then AdamW (2e-4, decay
    0.01) against the port's clip and ``torch.optim.AdamW``, the clip
    active on the first two."""
    rng = np.random.RandomState(15)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    tx = optax.chain(optax.clip_by_global_norm(35.0),
                     optax.adamw(2e-4, weight_decay=0.01))
    opt_state = tx.init(params)
    tparams = [torch.nn.Parameter(_t(a).clone())
               for a in jax.tree_util.tree_leaves(params)]
    opt = ttu.make_optimizer(tparams)
    for scale in (100.0, 50.0, 1.0):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.randn(*a.shape) * scale).astype(np.float32),
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for p, g in zip(tparams, jax.tree_util.tree_leaves(grads)):
            p.grad = _t(g).clone()
        from sndepth_tpu_torch.train.raft3d import clip_by_global_norm_
        clip_by_global_norm_([p.grad for p in tparams], ttu.CLIP_NORM)
        opt.step()
    for p, want in zip(tparams, jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   atol=1e-9, rtol=2e-6)


T_FRAMES = 3
_JAX_STEP = {}


def _jax_train_step(gts_on_detections: bool = False) -> dict:
    """The JAX train step of the small config on a ``T_FRAMES`` clip,
    jitted once for both clips: its loss terms, gradients and weights after
    the update, the QIM draws of its frames, the parameters it started
    from and the port's clip. With ``gts_on_detections`` the clip's GTs sit
    on the model's own detections (``clip_with_gts_on_detections``, run by
    the port from the same parameters and draws), so that the QIM keeps
    slots in every frame; else the synthetic clip keeps none."""
    if not _JAX_STEP:
        jm = jua.UniADTrack(**SMALL_TRAIN)
        clip = jtu.synthetic_clip(jm, t_frames=T_FRAMES, ng=3,
                                  img_hw=(64, 64))
        shapes = jax.eval_shape(
            lambda k: jtu.init_uniad_variables(jm, clip, k),
            jax.random.PRNGKey(0))["params"]
        tx = jtu.make_optimizer()

        def step(p, clip):
            def loss(p):
                return jm.apply({"params": p}, clip["imgs_seq"],
                                clip["lidar2img"], clip["gt"],
                                clip["timestamps"], method=jm.train_clip,
                                rngs={"qim": jax.random.PRNGKey(5)})
            (_, aux), g = jax.value_and_grad(loss, has_aux=True)(p)
            u, _ = tx.update(g, tx.init(p), p)
            return aux, g, optax.apply_updates(p, u)

        _JAX_STEP.update(clip=clip, params=_fill(shapes, seed=16),
                         step=jax.jit(step),
                         keys=[jax.random.PRNGKey(100 + t)
                               for t in range(T_FRAMES)])
    clip, params, keys = (_JAX_STEP["clip"], _JAX_STEP["params"],
                          _JAX_STEP["keys"])
    draws = []
    for key in keys:
        k_drop, k_fp = jax.random.split(key)
        draws.append((_t(jax.random.uniform(k_drop, (12,))),
                      _t(jax.random.uniform(k_fp, (12,)))))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    start = tw.uniad_state_dict_from_jax(to_np(params), BLOCKS)
    model = tua.UniADTrack(**SMALL_TRAIN)
    model.load_state_dict(start)
    port_clip = ttu.synthetic_clip(model, t_frames=T_FRAMES, ng=3,
                                   img_hw=(64, 64))
    if gts_on_detections:
        port_clip = ttu.clip_with_gts_on_detections(model, port_clip, draws)
        clip = {**clip, "gt": {
            k: jnp.asarray(port_clip["gt"][k].numpy().astype(
                np.asarray(v).dtype)) for k, v in clip["gt"].items()}}
    # The JAX QIM draws from a key of each frame, which a wrapper hands it
    # while the step is traced.
    real = jua.qim_select_train
    calls = []

    def select(tracks, rng, **kw):
        key = keys[len(calls) % T_FRAMES]
        calls.append(key)
        return real(tracks, key, **kw)

    jua.qim_select_train = select
    try:
        aux, grads, new = _JAX_STEP["step"](params, clip)
    finally:
        jua.qim_select_train = real
    return {"aux": {k: float(v) for k, v in aux.items()},
            "grads": tw.uniad_state_dict_from_jax(to_np(grads), BLOCKS),
            "new": tw.uniad_state_dict_from_jax(to_np(new), BLOCKS),
            "params": start, "draws": draws, "clip": port_clip}


@pytest.fixture(scope="module")
def jax_step():
    """The JAX train step on the synthetic clip."""
    return _jax_train_step()


def _port_step(jax_step, remat=False):
    model = tua.UniADTrack(**SMALL_TRAIN, remat=remat)
    model.load_state_dict(jax_step["params"])
    state = ttu.create_train_state(model, "cpu")
    metrics = ttu.train_step(state, jax_step["clip"], jax_step["draws"])
    return state, metrics


def _check_step(state, metrics, ref) -> dict:
    """The port's step against the JAX step ``ref``: the loss terms, each
    gradient before the clip and the weights after AdamW. Returns the
    gradients before the clip."""
    for k, v in ref["aux"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5,
                                   err_msg=k)
    # The gradients before the clip (its scale undone), then the weights.
    scale = max(float(metrics["grad_norm"]) / ttu.CLIP_NORM, 1.0)
    grads = {n: p.grad * scale for n, p in state.model.named_parameters()}
    assert set(grads) == set(ref["grads"])
    floor = 1e-5 * float(torch.sqrt(sum((g.double() ** 2).sum()
                                        for g in ref["grads"].values())))
    for n, g in grads.items():
        assert torch.isfinite(g).all(), n
        want = ref["grads"][n]
        rel = float((g - want).norm()) / max(float(want.norm()), floor)
        assert rel < 1e-4, (n, rel)
    lr, off, total = 2e-4, 0, 0
    for n, p in state.model.named_parameters():
        d = (p.detach() - ref["new"][n]).abs()
        assert float(d.max()) <= 2.01 * lr, n
        off += int((d > 0.01 * lr).sum())
        total += d.numel()
    assert off <= 1e-3 * total, off
    assert state.step == 1 and state.notfinite_count == 0
    return grads


def test_one_train_step_matches_jax(jax_step):
    state, metrics = _port_step(jax_step)
    _check_step(state, metrics, jax_step)
    assert [int(d["matched"].sum()) for d in state.decisions] == [3, 3, 3]


def test_one_train_step_with_kept_slots_matches_jax(jax_step):
    """The clip's GTs on the model's own detections: the QIM keeps slots in
    every frame, so its update and the memory bank reach the loss, and
    their gradients (nonzero) hold against JAX's."""
    ref = _jax_train_step(gts_on_detections=True)
    state, metrics = _port_step(ref)
    grads = _check_step(state, metrics, ref)
    kept = [int(d["keep"].sum()) for d in state.decisions]
    assert all(k > 0 for k in kept), kept
    for n, g in grads.items():
        if n.startswith(("query_interact.", "memory_bank.")):
            assert float(g.norm()) > 0.0, n


def test_remat_leaves_the_loss_and_gradients(jax_step):
    """``remat=True`` recomputes each attention and FFN sublayer in the
    backward pass and changes no value."""
    base, m0 = _port_step(jax_step)
    remat, m1 = _port_step(jax_step, remat=True)
    assert float(m0["loss_total"]) == float(m1["loss_total"])
    # The recomputed sublayers' gradients reach shared inputs in another
    # order: the last bits may differ.
    for (n, p), (_, q) in zip(base.model.named_parameters(),
                              remat.model.named_parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=1e-5, atol=1e-7,
                                   msg=n)


def test_train_step_skips_a_non_finite_update(jax_step):
    """A non-finite loss moves no weight and is counted."""
    model = tua.UniADTrack(**SMALL_TRAIN)
    model.load_state_dict(jax_step["params"])
    clip = ttu.synthetic_clip(model, t_frames=T_FRAMES, ng=3, img_hw=(64, 64))
    clip["gt"]["boxes"][0, 0, 0] = float("nan")
    state = ttu.create_train_state(model, "cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ttu.train_step(state, clip, jax_step["draws"])
    assert state.step == 0 and state.calls == 1 and state.notfinite_count == 1
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n


def test_train_uniad_cli_runs_on_the_cpu(tmp_path):
    """``train_uniad --small`` for two steps writes ``uniad.pth`` and its
    train state, which restore into a fresh state."""
    state, records = train_uniad.main(
        ["--small", "--max_steps", "2", "--log_every", "1", "--device",
         "cpu", "--t_frames", "2", "--ckpt_dir", str(tmp_path / "ck")])
    assert state.step == 2 and len(records) == 2
    assert all(np.isfinite(r["loss_total"]) for r in records)
    assert (tmp_path / "ck" / loop.UNIAD_MODEL_FILE).exists()
    fresh = ttu.create_train_state(train_uniad.small_model(), "cpu")
    loop.restore_uniad_checkpoint(fresh, str(tmp_path / "ck"))
    assert fresh.step == 2
    for (n, p), (_, q) in zip(fresh.model.named_parameters(),
                              state.model.named_parameters()):
        assert torch.equal(p, q), n
