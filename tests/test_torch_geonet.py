"""One float32 GeoNet stage-1 train step of the PyTorch port against
``sndepth_tpu.train.geonet.train_step``, from the same carried weights.

The JAX step runs on the CPU with its split ops (the Pallas kernels are
TPU-gated), the port's step on the CPU with the plain versions of its
kernels. Adam's first moment after one step is (1 - b1) * grad on both
sides, so the JAX gradients are read from the optimizer state of the one
compiled ``train_step``.

Tolerances: the loss agrees to rtol 1e-5 (float32 sums over ~10^5 terms in
different orders). Gradients are compared per tensor by the L2 norm of the
difference over the norm of the JAX gradient. DispNetS: 2e-4; both sides
are float32 with different convolution algorithms and summation orders
through ~30 layers (measured: <= 3.3e-5). PoseNet: 1e-2; its gradient is
a sum over all pixels of terms that largely cancel, and a float64
evaluation of the port puts both float32 sides ~5e-3 from it (measured:
the two sides agree to 1.4e-3). After one Adam step the update
is lr * g / (|g| + eps), about lr * sign(g), so parameters agree to
atol 2e-6 (1% of lr) except where a gradient is within rounding of zero;
at most 0.1% of entries may differ there, and none by more than 2 * lr.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sndepth_tpu.core.config import GeoNetConfig as JaxGeoNetConfig
from sndepth_tpu.train import geonet as jgeo
from sndepth_tpu_torch.core.config import GeoNetConfig
from sndepth_tpu_torch.data.synthetic import synthetic_batches
from sndepth_tpu_torch.train import geonet as tgeo
from sndepth_tpu_torch.utils.threads import torch_threads
from sndepth_tpu_torch.utils.weights import (dispnet_state_dict_from_jax,
                                             posenet_state_dict_from_jax)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


def _drawn(shapes, seed, lecun=lambda keys: False):
    """Parameters of the shapes of ``jax.eval_shape`` of an ``init``, drawn
    by numpy from the distributions flax draws them from: xavier-uniform
    kernels (LeCun-normal where ``lecun(keys)``: flax's default), zero
    biases. Nothing is computed on the JAX side."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        keys = [p.key for p in path]
        shape = leaf.shape
        if keys[-1] != "kernel":
            return np.zeros(shape, np.float32)
        fan_in = int(np.prod(shape[:-1]))
        fan_out = int(np.prod(shape[:-2])) * shape[-1]
        if lecun(keys):
            a = np.clip(rng.randn(*shape), -2, 2) / 0.87962566 / np.sqrt(fan_in)
        else:
            lim = np.sqrt(6.0 / (fan_in + fan_out))
            a = rng.uniform(-lim, lim, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)

B, H, W = 2, 32, 64
JCFG = JaxGeoNetConfig(batch_size=B, img_height=H, img_width=W,
                       compute_dtype=jnp.float32)
TCFG = GeoNetConfig(batch_size=B, img_height=H, img_width=W,
                    compute_dtype=torch.float32)
LR = TCFG.learning_rate


def _batch(seed=3):
    batch = next(synthetic_batches(B, H, W, seed=seed))
    rng = np.random.RandomState(seed)
    # Perturb the intrinsics so the rigid flows are not symmetric.
    batch["intrinsics"] = (batch["intrinsics"]
                           * rng.uniform(0.9, 1.1, (B, 3, 3))
                           ).astype(np.float32)
    return batch


def _state_dicts(tree):
    return {**{"disp." + k: v.numpy() for k, v in
               dispnet_state_dict_from_jax(tree["disp"]).items()},
            **{"pose." + k: v.numpy() for k, v in
               posenet_state_dict_from_jax(tree["pose"]).items()}}


def _torch_named(state, attr):
    out = {}
    for prefix, net in (("disp.", state.disp_net), ("pose.", state.pose_net)):
        for k, p in net.named_parameters():
            out[prefix + k] = attr(p).detach().numpy()
    return out


def _jax_state():
    """``jgeo.create_train_state`` with numpy-drawn weights: the eager
    flax init of both nets costs seconds and checks nothing here."""
    shapes = jax.eval_shape(lambda: jgeo.create_train_state(JCFG))
    params = jax.tree_util.tree_map(jnp.asarray, _drawn(shapes.params, 0))
    return jgeo.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=jgeo.make_optimizer(JCFG).init(params),
        rng=jax.random.PRNGKey(JCFG.seed))


def _run_steps():
    """Both steps from the same weights, on a good and then a NaN batch."""
    jstate = _jax_state()
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstep = jax.jit(functools.partial(jgeo.train_step, config=JCFG))
    batch = _batch()
    bad = dict(batch, intrinsics=np.full_like(batch["intrinsics"], np.nan))

    jstate1, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    jstate2, _ = jstep(jstate1, {k: jnp.asarray(v) for k, v in bad.items()})

    tstate = tgeo.create_train_state(TCFG, "cpu")
    tstate.disp_net.load_state_dict(dispnet_state_dict_from_jax(params0["disp"]))
    tstate.pose_net.load_state_dict(posenet_state_dict_from_jax(params0["pose"]))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tmet = tgeo.train_step(tstate, tb, TCFG)
    t_grads = _torch_named(tstate, lambda p: p.grad)
    t_params1 = _torch_named(tstate, lambda p: p)
    tmet_bad = tgeo.train_step(
        tstate, {k: torch.from_numpy(v) for k, v in bad.items()}, TCFG)
    return dict(jstate1=jstate1, jstate2=jstate2, jmet=jmet, tstate=tstate,
                tmet=tmet, tmet_bad=tmet_bad, t_grads=t_grads,
                t_params1=t_params1, bad=bad)


@pytest.fixture(scope="module")
def steps():
    return _run_steps()


def test_train_step_loss_matches_jax(steps):
    for key in ("loss_total", "loss_rigid_warp", "loss_disp_smooth"):
        got = float(steps["tmet"][key])
        assert np.isfinite(got)
        np.testing.assert_allclose(got, float(steps["jmet"][key]), rtol=1e-5)


def test_train_step_gradients_match_jax(steps):
    adam = steps["jstate1"].opt_state.inner_state[0]
    j_grads = _state_dicts(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1.0 - JCFG.adam_beta1), adam.mu))
    t_grads = steps["t_grads"]
    assert set(t_grads) == set(j_grads)
    for k, g in t_grads.items():
        assert np.isfinite(g).all(), k
        tol = 2e-4 if k.startswith("disp.") else 1e-2
        err = np.linalg.norm(g - j_grads[k]) / np.linalg.norm(j_grads[k])
        assert err <= tol, (k, err)


def test_train_step_params_after_adam_match_jax(steps):
    j_params = _state_dicts(jax.tree_util.tree_map(
        np.asarray, steps["jstate1"].params))
    t_params = steps["t_params1"]
    n_off, n_all = 0, 0
    for k, p in t_params.items():
        diff = np.abs(p - j_params[k])
        assert diff.max() <= 2 * LR, k
        n_off += int((diff > 2e-6).sum())
        n_all += diff.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def test_nonfinite_step_is_skipped_like_jax(steps):
    tstate = steps["tstate"]
    assert not np.isfinite(float(steps["tmet_bad"]["loss_total"]))
    assert tstate.notfinite_count == 1
    assert int(steps["jstate2"].opt_state.notfinite_count) == 1
    for k, p in _torch_named(tstate, lambda p: p).items():
        np.testing.assert_array_equal(p, steps["t_params1"][k], err_msg=k)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)),
        steps["jstate1"].params, steps["jstate2"].params)


def test_synthetic_stream_matches_jax():
    from sndepth_tpu.data.prefetch import synthetic_batches as jax_stream
    for want, got in zip(jax_stream(B, H, W, seed=7),
                         synthetic_batches(B, H, W, seed=7)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        break


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    """Two CLI steps on the CPU with a checkpoint each, then a resumed
    run to step 3 that starts from the saved weights and counters."""
    from sndepth_tpu_torch.cli import train_geonet
    from sndepth_tpu_torch.train.loop import latest_checkpoint
    args = ["--device", "cpu", "--dtype", "float32", "--batch_size", "1",
            "--img_height", "32", "--img_width", "64", "--log_every", "1",
            "--output_ckpt_iter", "1", "--ckpt_dir", str(tmp_path / "ck"),
            "--graphs_dir", str(tmp_path / "logs")]
    state, records = train_geonet.main(args + ["--max_steps", "2"])
    assert state.step == 2 and [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss_total"]) for r in records)
    path = latest_checkpoint(str(tmp_path / "ck"))
    assert path.endswith("step_00000002.pt")

    saved = torch.load(path, weights_only=True)
    resumed, _ = train_geonet.main(args + ["--max_steps", "2", "--resume"])
    assert resumed.step == 2
    for k, v in resumed.disp_net.state_dict().items():
        torch.testing.assert_close(v, saved["disp_net"][k], rtol=0, atol=0)
    assert resumed.optimizer.state_dict()["state"][0]["step"] == 2

    state3, records3 = train_geonet.main(args + ["--max_steps", "3",
                                                 "--resume"])
    assert state3.step == 3 and [r["step"] for r in records3] == [3]


def test_too_many_nonfinite_steps_raise(steps):
    tstate = tgeo.create_train_state(TCFG, "cpu")
    tstate.notfinite_count = tgeo.MAX_CONSECUTIVE_SKIPS
    bad = {k: torch.from_numpy(v) for k, v in steps["bad"].items()}
    with pytest.raises(FloatingPointError):
        tgeo.train_step(tstate, bad, TCFG)
