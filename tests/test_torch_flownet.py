"""The port's FlowNet against the JAX FlowNet in float32, with the JAX
weights carried over by ``flownet_state_dict_from_jax``, and that carry-over
against the JAX package's own ``convert_flownet``.

Tolerances: flows rtol 1e-4 / atol 1e-5 (float32 convolutions through up to
20 layers, with other algorithms and summation orders on the two sides; the
flows are ~0.1 in magnitude); the weight round trip is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sndepth_tpu.models.flownet import FlowNet as JaxFlowNet
from sndepth_tpu.utils.convert_weights import convert_flownet
from sndepth_tpu_torch.models.dispnet import init_weights
from sndepth_tpu_torch.models.flownet import FlowNet
from sndepth_tpu_torch.utils.layout import to_nchw, to_nhwc
from sndepth_tpu_torch.utils.threads import torch_threads
from sndepth_tpu_torch.utils.weights import flownet_state_dict_from_jax


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


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed, shape):
    return (np.random.RandomState(seed).rand(*shape) * 2 - 1).astype(
        np.float32)


def _jax_net_and_params(x, scale, **knobs):
    jnet = JaxFlowNet(flow_scale_factor=scale, dtype=jnp.float32, **knobs)
    heads = lambda keys: len(keys) == 2 and keys[0].startswith("Conv_")
    params = _drawn(jax.eval_shape(jnet.init, jax.random.PRNGKey(1),
                                   jnp.asarray(x))["params"], 1, heads)
    return jnet, params


@pytest.mark.parametrize("size", [(32, 64), (16, 52)],
                         ids=["32x64", "16x52_reaches_1x1"])
def test_flownet_forward_matches_jax(size):
    """16x52 shrinks to 1x1 at the seventh level and through odd sizes on
    the way (13, 7), so every decoder level crops."""
    x = _inputs(0, (2,) + size + (12,))
    jnet, params = _jax_net_and_params(x, 0.1)
    want = jax.jit(jnet.apply)({"params": params}, jnp.asarray(x))

    net = FlowNet(12, 0.1)
    net.load_state_dict(flownet_state_dict_from_jax(params))
    with torch.no_grad():
        got = net(torch.from_numpy(to_nchw(x)))
    assert len(got) == 4
    for s, (g, w) in enumerate(zip(got, want)):
        g = to_nhwc(g.numpy())
        assert g.shape == w.shape == (2, -(-size[0] // 2 ** s),
                                      -(-size[1] // 2 ** s), 2)
        assert np.isfinite(g).all() and np.abs(g).max() > 0
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)


def test_flownet_state_dict_round_trips_through_the_jax_converter():
    x = jnp.zeros((1, 32, 64, 12))
    _, params = _jax_net_and_params(x, 1.0, s2d_levels=())
    net = FlowNet(12)
    sd = flownet_state_dict_from_jax(params)
    assert set(sd) == set(net.state_dict())
    assert {"conv1.0.weight", "conv7.2.bias", "upconv7.0.weight",
            "iconv1.0.bias", "flow4.weight", "flow1.bias"} <= set(sd)
    net.load_state_dict(sd)
    back = convert_flownet({k: v.numpy() for k, v in net.state_dict().items()})
    flat_o = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_o) == len(flat_b)
    for path, leaf in flat_o:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_flow_heads_run_in_float32_under_bf16_convolutions():
    """The heads stay float32 on a float32 cast of their input, so the bf16
    net's flows differ from the float32 net's only by what the bf16
    convolutions before them lose."""
    gen = torch.Generator().manual_seed(0)
    net32, net16 = FlowNet(12, 0.1), FlowNet(12, 0.1, dtype=torch.bfloat16)
    init_weights(net32, gen)
    net16.load_state_dict(net32.state_dict())
    x = torch.from_numpy(to_nchw(_inputs(3, (1, 32, 64, 12))))
    with torch.no_grad():
        out32, out16 = net32(x), net16(x)
    for a, b in zip(out32, out16):
        assert b.dtype == torch.float32 and torch.isfinite(b).all()
        assert float((a - b).abs().max()) <= 0.05 * float(a.abs().max()) + 1e-3
    assert net16.flow1.weight.dtype == torch.float32


def test_flow_scale_factor_scales_the_heads_only():
    gen = torch.Generator().manual_seed(1)
    unit, tenth = FlowNet(12, 1.0), FlowNet(12, 0.1)
    init_weights(unit, gen)
    tenth.load_state_dict(unit.state_dict())
    x = torch.from_numpy(to_nchw(_inputs(4, (1, 16, 52, 12))))
    with torch.no_grad():
        # The coarsest flow feeds nothing before it, so it scales exactly.
        torch.testing.assert_close(tenth(x)[3], 0.1 * unit(x)[3],
                                   rtol=1e-6, atol=1e-8)
