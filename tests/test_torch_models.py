"""The port's DispNetS and PoseNet against the JAX models in float32, with
the JAX weights carried over by ``sndepth_tpu_torch.utils.weights``, and
the carry-over against the JAX package's own converter.

Tolerances: disparities rtol 1e-4/atol 1e-5 and poses atol 1e-6 (float32
convolutions through up to 20 layers, with other algorithms and summation
orders on the two sides); the weight round trip is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sndepth_tpu.models.dispnet import DispNetS as JaxDispNetS
from sndepth_tpu.models.posenet import PoseNet as JaxPoseNet
from sndepth_tpu.utils.convert_weights import convert_dispnet, convert_posenet
from sndepth_tpu_torch.models.dispnet import DispNetS, upsample2x
from sndepth_tpu_torch.models.posenet import PoseNet
from sndepth_tpu_torch.utils.layout import to_nchw, to_nhwc
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

NARROW = dict(enc_planes=(8, 8, 16, 16, 16, 16, 16),
              dec_planes=(16, 16, 16, 16, 8, 8, 4))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _img(seed, shape):
    return (np.random.RandomState(seed).rand(*shape) * 2 - 1).astype(
        np.float32)


@pytest.mark.parametrize("size,planes", [((32, 64), {}),
                                         ((40, 72), NARROW)],
                         ids=["full_width_32x64", "narrow_40x72"])
def test_dispnet_forward_matches_jax(size, planes):
    """40x72 makes odd sizes deep in the encoder, so the decoder crops."""
    x = _img(0, (2,) + size + (3,))
    jnet = JaxDispNetS(dtype=jnp.float32, remat=False, s2d_levels=(),
                       **planes)
    params = _drawn(jax.eval_shape(jnet.init, jax.random.PRNGKey(1),
                                   jnp.asarray(x))["params"], 1)
    want = jax.jit(jnet.apply)({"params": params}, jnp.asarray(x))

    net = DispNetS(**planes)
    net.load_state_dict(dispnet_state_dict_from_jax(params))
    with torch.no_grad():
        got = net(torch.from_numpy(to_nchw(x)))
    assert len(got) == 4
    for g, w in zip(got, want):
        g = to_nhwc(g.numpy())
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("size", [(32, 64), (64, 96)])
def test_posenet_forward_matches_jax(size):
    x = _img(2, (2,) + size + (9,))
    jnet = JaxPoseNet(num_source=2, dtype=jnp.float32)
    params = _drawn(jax.eval_shape(jnet.init, jax.random.PRNGKey(3),
                                   jnp.asarray(x))["params"], 3)
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    net = PoseNet(num_source=2)
    net.load_state_dict(posenet_state_dict_from_jax(params))
    with torch.no_grad():
        got = net(torch.from_numpy(to_nchw(x))).numpy()
    assert got.shape == (2, 2, 6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_state_dicts_round_trip_through_the_jax_converter():
    jd = JaxDispNetS(dtype=jnp.float32, remat=False, **NARROW)
    jp = JaxPoseNet(num_source=2, dtype=jnp.float32)
    x = jnp.zeros((1, 32, 64, 3))
    dparams = _drawn(jax.eval_shape(jd.init, jax.random.PRNGKey(4), x)[
        "params"], 4)
    pparams = _drawn(jax.eval_shape(jp.init, jax.random.PRNGKey(5),
                                    jnp.zeros((1, 32, 64, 9)))["params"], 5)
    dnet, pnet = DispNetS(**NARROW), PoseNet(num_source=2)
    dnet.load_state_dict(dispnet_state_dict_from_jax(dparams))
    pnet.load_state_dict(posenet_state_dict_from_jax(pparams))
    back_d = convert_dispnet({k: v.numpy() for k, v in
                              dnet.state_dict().items()})
    back_p = convert_posenet({k: v.numpy() for k, v in
                              pnet.state_dict().items()})
    for orig, back in ((dparams, back_d), (pparams, back_p)):
        flat_o = jax.tree_util.tree_flatten_with_path(orig)[0]
        flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_o) == len(flat_b)
        for path, leaf in flat_o:
            np.testing.assert_array_equal(flat_b[path], leaf)


def test_upsample2x_matches_jax_resize_at_the_borders():
    x = _img(6, (1, 5, 7, 1))
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 10, 14, 1),
                                       "bilinear"))
    got = to_nhwc(upsample2x(torch.from_numpy(to_nchw(x))).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]], atol=1e-6)
    np.testing.assert_allclose(got[:, :, [0, -1]], want[:, :, [0, -1]],
                               atol=1e-6)


def test_bf16_forward_runs_and_keeps_float32_outputs():
    net = DispNetS(dtype=torch.bfloat16, **NARROW)
    with torch.no_grad():
        out = net(torch.from_numpy(to_nchw(_img(7, (1, 32, 64, 3)))))
    for d in out:
        assert d.dtype == torch.float32 and torch.isfinite(d).all()
        assert float(d.min()) >= 0.01 and float(d.max()) <= 10.01
