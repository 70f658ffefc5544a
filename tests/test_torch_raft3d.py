"""The port's RAFT3D against ``sndepth_tpu.models.raft3d`` on the CPU, on
the same inputs and weights, made from a seed with numpy: the encoders, the
update block (both variants), the correlation pyramid and its two lookups,
one refinement iteration from a given carry, the whole model with two
iterations (both variants, and the ``train_mode`` outputs), the weight
round trip, and the two entry points on ``--device cpu`` at a small size.

The JAX parameters come from ``jax.eval_shape`` of the model's ``init`` and
numpy (LeCun-normal kernels, non-trivial biases and BatchNorm statistics),
once per module; they reach the port through
``raft3d_state_dict_from_jax``. Images are 64x80: the smallest multiple of
8 that keeps all 4 correlation levels, with an odd side (5) in the pyramid.

Tolerances: nets and update block atol 1e-4 + rtol 1e-4 (float32
convolutions that sum up to 2304 products of O(1) values in another order,
through up to 53 layers, with instance norms in between: measured up to
3.2e-5, depending on how many threads the CPU convolutions run with); the
lookups atol 1e-5; one iteration and the whole model atol 5e-5 + rtol 1e-4
on the SE3 field (measured 3e-6: the Gauss-Newton solve damps the nets'
last digits). Every output is asserted finite.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sndepth_tpu.models import raft3d as jraft
from sndepth_tpu.ops import se3 as jse3
from sndepth_tpu.utils.convert_weights import convert_raft3d
from sndepth_tpu_torch.models import raft3d as traft
from sndepth_tpu_torch.utils.layout import to_nchw, to_nhwc
from sndepth_tpu_torch.utils.threads import torch_threads
from sndepth_tpu_torch.utils.weights import raft3d_state_dict_from_jax


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield

H, W = 64, 80
NET = dict(atol=1e-4, rtol=1e-4)
FIELD = dict(atol=5e-5, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _frame(seed=0, b=1):
    rng = np.random.RandomState(seed)
    im1, im2 = (rng.rand(b, H, W, 3).astype(np.float32) for _ in range(2))
    d1, d2 = ((2 + rng.rand(b, H, W)).astype(np.float32) for _ in range(2))
    k = np.tile(np.array([[W * 0.58, H * 1.92, W / 2, H / 2]], np.float32),
                (b, 1))
    return im1, im2, d1, d2, k


def _variables(bilaplacian):
    model = jraft.RAFT3D(bilaplacian=bilaplacian)
    frame = tuple(map(jnp.asarray, _frame()))
    shapes = jax.eval_shape(
        lambda key: model.init(key, *frame, iters=1), jax.random.PRNGKey(0))
    rng = np.random.RandomState(1 + bilaplacian)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            a = rng.randn(*leaf.shape) / np.sqrt(fan_in)
        elif name == "var":
            a = 0.5 + rng.rand(*leaf.shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.randn(*leaf.shape)
        else:                                    # bias, mean
            a = 0.1 * rng.randn(*leaf.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "bilaplacian"])
def pair(request):
    """(bilaplacian, JAX variables, the port's model with them loaded)."""
    variables = _variables(request.param)
    model = traft.RAFT3D(bilaplacian=request.param).eval()
    model.load_state_dict(raft3d_state_dict_from_jax(
        variables["params"], variables["batch_stats"]))
    return request.param, variables, model


def _check(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, **tol)


def test_state_dict_keys_are_the_reference_names(pair):
    bilaplacian, variables, model = pair
    keys = set(model.state_dict())
    for key in ("fnet.conv1.weight", "fnet.layer2.0.downsample.0.weight",
                "fnet.layer3.1.conv2.bias", "fnet.conv2.bias",
                "cnet.conv1.weight", "cnet.bn1.running_var",
                "cnet.layer3.5.bn3.weight", "cnet.layer4.0.downsample.1.bias",
                "cnet.uconv3.weight", "update_block.corr_enc.4.weight",
                "update_block.flow_enc.2.bias",
                "update_block.gru.convq2.weight", "update_block.ae.2.weight",
                "update_block.mask.0.bias", "update_block.delta.2.weight",
                "update_block.weight.2.bias"):
        assert key in keys, key
    assert "cnet.conv1.bias" not in keys and "fnet.layer1.0.downsample.0.weight" not in keys
    assert ("update_block.ae_enc.weight" in keys) == bilaplacian
    assert ("update_block.ae_wts.2.weight" in keys) == bilaplacian
    assert model.update_block.ae[2].out_channels == (16 if bilaplacian else 32)


def test_weight_round_trip_through_the_jax_converter_is_exact(pair):
    """The plain variant's state_dict through ``convert_raft3d`` gives the
    JAX variables back bit for bit; for the bilaplacian variant, whose extra
    layers the converter does not cover, every tensor it does cover."""
    bilaplacian, variables, model = pair
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = convert_raft3d({"module." + k: v for k, v in sd.items()})
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    want = dict(jax.tree_util.tree_leaves_with_path(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}))
    if not bilaplacian:
        assert set(got) == set(want)
    else:
        missing = {jax.tree_util.keystr(p) for p in set(want) - set(got)}
        assert len(missing) == 6 and all("ae_" in m for m in missing)
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf, want[path],
                                      err_msg=jax.tree_util.keystr(path))


def test_basic_encoder_matches_jax(pair):
    _, variables, model = pair
    x = _frame(2, b=2)[0]
    want = jraft.BasicEncoder().apply(
        {"params": variables["params"]["BasicEncoder_0"]}, jnp.asarray(x))
    with torch.no_grad():
        got = model.fnet(_t(to_nchw(x)))
    assert got.shape == (2, 128, H // 8, W // 8)
    _check(to_nhwc(got.numpy()), want, **NET)


def test_fpn_context_matches_jax_on_running_statistics(pair):
    _, variables, model = pair
    x = _frame(3, b=2)[0]
    want = jraft.FPNContext().apply(
        {"params": variables["params"]["FPNContext_0"],
         "batch_stats": variables["batch_stats"]["FPNContext_0"]},
        jnp.asarray(x))
    model.train()          # the running statistics are used all the same
    try:
        with torch.no_grad():
            got = model.cnet(_t(to_nchw(x)))
    finally:
        model.eval()
    assert got.shape == (2, 512, H // 8, W // 8)
    _check(to_nhwc(got.numpy()), want, **NET)


def _block_inputs(bilaplacian, seed=4, b=2, h=8, w=10):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return dict(net=np.tanh(f(b, h, w, 128)), inp=np.abs(f(b, h, w, 384)),
                corr=f(b, h, w, 196), flow=3 * f(b, h, w, 2),
                twist=0.1 * f(b, h, w, 6), dz=0.1 * f(b, h, w, 1),
                ae_in=f(b, h, w, 16) if bilaplacian else None)


def test_update_block_matches_jax(pair):
    bilaplacian, variables, model = pair
    a = _block_inputs(bilaplacian)
    params = variables["params"]["Scan_RAFTIteration_0"]["BasicUpdateBlock_0"]
    want = jraft.BasicUpdateBlock(bilaplacian=bilaplacian).apply(
        {"params": params}, *(None if v is None else jnp.asarray(v)
                              for v in a.values()))
    with torch.no_grad():
        got = model.update_block(
            _t(to_nchw(a["net"])), _t(to_nchw(a["inp"])),
            _t(to_nchw(a["corr"])), _t(a["flow"]), _t(a["twist"]),
            _t(a["dz"]), None if a["ae_in"] is None else _t(a["ae_in"]))
    names = ("net", "mask", "ae", "delta", "weight")
    assert got[2].shape[-1] == (16 if bilaplacian else 32)
    for name, g, w_ in zip(names, got, want):
        g = to_nhwc(g.numpy()) if name == "net" else g.numpy()
        # The smoothed embedding goes through 16 conjugate-gradient steps.
        tol = dict(atol=2e-4, rtol=1e-3) if (bilaplacian and name == "ae") \
            else NET
        _check(g, w_, **tol)


def test_bilaplacian_block_needs_the_previous_embedding():
    block = traft.BasicUpdateBlock(bilaplacian=True)
    a = _block_inputs(False, b=1, h=4, w=4)
    with pytest.raises(ValueError):
        block(_t(to_nchw(a["net"])), _t(to_nchw(a["inp"])),
              _t(to_nchw(a["corr"])), _t(a["flow"]), _t(a["twist"]),
              _t(a["dz"]))


def test_grad_clip_is_identity_forward_and_zeroes_large_or_nan_gradients():
    x = torch.tensor([1.0, -2.0, 3.0, 4.0], requires_grad=True)
    y = traft.grad_clip(x)
    assert torch.equal(y, x)
    y.backward(torch.tensor([0.005, -0.02, float("nan"), -0.01]))
    want = jax.vjp(jraft.grad_clip, jnp.asarray([1.0, -2.0, 3.0, 4.0]))[1](
        jnp.asarray([0.005, -0.02, np.nan, -0.01]))[0]
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        x.grad.numpy(), np.array([0.005, 0.0, 0.0, -0.01], np.float32))


@pytest.mark.parametrize("hw", [(16, 52), (47, 156), (5, 7), (8, 8), (3, 2)])
def test_pool_fmap_pyramid_truncates_odd_sizes_like_avg_pool(hw):
    h, w = hw
    f = np.random.RandomState(5).randn(2, h, w, 6).astype(np.float32)
    got = traft.pool_fmap_pyramid(_t(to_nchw(f)), 4)
    want = jraft.pool_fmap_pyramid(jnp.asarray(f), 4)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        _check(to_nhwc(g.numpy()), w_, atol=1e-6, rtol=1e-6)
    if hw == (47, 156):
        assert [tuple(g.shape[2:]) for g in got] == [(47, 156), (23, 78),
                                                     (11, 39), (5, 19)]
    if hw == (3, 2):
        assert len(got) == 2           # a 1 x 1 level ends the pyramid


def _lookup_case(seed, h=7, w=9, c=16):
    rng = np.random.RandomState(seed)
    f1, f2 = (rng.randn(2, h, w, c).astype(np.float32) for _ in range(2))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = (np.stack([xs, ys], -1)[None]
              + 4 * rng.randn(2, h, w, 2)).astype(np.float32)
    # Queries whose whole window misses the image, on every side, one on
    # the clamp's bounds, and integer coordinates on the border.
    coords[0, 0, :6] = [[-40.0, 3.0], [3.0, -40.0], [w + 35.0, 2.0],
                        [2.0, h + 35.0], [-1e6, 1e6], [w - 1.0, h - 1.0]]
    coords[1, 0, :2] = [[-5.0 - 1e-3, 2.0], [w + 3.0, h + 3.0]]
    return f1, f2, coords


@pytest.mark.parametrize("radius", [3, 4])
def test_corr_lookup_dot_matches_jax_and_the_volume_lookup(radius):
    f1, f2, coords = _lookup_case(6 + radius)
    t1, t2 = _t(to_nchw(f1)), _t(to_nchw(f2))
    got = traft.corr_lookup_dot(t1, traft.pool_fmap_pyramid(t2, 4),
                                _t(coords), radius)
    win2 = (2 * radius + 1) ** 2
    assert got.shape == (2, 3 * win2, 7, 9)       # 7x9, 3x4, 1x2: 3 levels
    want = jraft.corr_lookup_dot(
        jnp.asarray(f1), jraft.pool_fmap_pyramid(jnp.asarray(f2), 4),
        jnp.asarray(coords), radius)
    _check(to_nhwc(got.numpy()), want, atol=1e-5, rtol=1e-5)
    volume = traft.corr_lookup(traft.build_corr_pyramid(t1, t2, 4),
                               _t(coords), radius)
    _check(volume, got.numpy(), atol=1e-5, rtol=1e-5)
    jvolume = jraft.corr_lookup(
        jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4),
        jnp.asarray(coords), radius)
    _check(to_nhwc(volume.numpy()), jvolume, atol=1e-5, rtol=1e-5)
    # A query whose whole window misses the image reads exactly 0.
    out = to_nhwc(got.numpy())
    for b, x in ((0, 0), (0, 1), (0, 2), (0, 3), (0, 4)):
        assert (out[b, 0, x] == 0).all(), (b, x)
    assert np.abs(out[0, 0, 5]).max() > 0


def test_model_refuses_an_image_too_small_for_its_pyramid():
    model = traft.RAFT3D()
    x, d = torch.zeros(1, 3, 48, 64), torch.ones(1, 48, 64)
    with pytest.raises(ValueError, match="correlation levels"):
        model(x, x, d, d, torch.ones(1, 4))


def _torch_frame(frame):
    im1, im2, d1, d2, k = frame
    return (_t(to_nchw(im1)), _t(to_nchw(im2)), _t(d1), _t(d2), _t(k))


def test_one_iteration_from_a_given_carry_matches_jax(pair):
    bilaplacian, variables, model = pair
    frame = _frame(8)
    with torch.no_grad():
        const, net = model.features(*_torch_frame(frame))
    rng = np.random.RandomState(9)
    h8, w8 = H // 8, W // 8
    Ts = np.array(jse3.exp(jnp.asarray(
        (0.02 * rng.randn(1, h8, w8, 6)).astype(np.float32))))
    ae = rng.randn(1, h8, w8, 16 if bilaplacian else 32).astype(np.float32)
    with torch.no_grad():
        (Ts1, net1, ae1), mask = model.iteration((_t(Ts), net, _t(ae)), const)

    jconst = (to_nhwc(const["fmap1"].numpy()),
              tuple(to_nhwc(f.numpy()) for f in const["f2_pyramid"]),
              to_nhwc(const["inp"].numpy()), const["coords0"].numpy(),
              const["depth1_r8"].numpy(), const["depth2_r8"].numpy(),
              const["intrinsics_r8"].numpy(), const["depth1"].numpy(),
              const["intrinsics"].numpy())
    body = jraft._RAFTIteration(
        hidden_dim=128, corr_radius=3, gn_radius=32, train_mode=False,
        bilaplacian=bilaplacian, dtype=jnp.float32)
    (jTs, jnet, jae), jmask = jax.jit(body.apply)(
        {"params": variables["params"]["Scan_RAFTIteration_0"]},
        (jnp.asarray(Ts), jnp.asarray(to_nhwc(net.numpy())), jnp.asarray(ae)),
        jax.tree_util.tree_map(jnp.asarray, jconst))
    _check(Ts1, jTs, **FIELD)
    _check(to_nhwc(net1.numpy()), jnet, **NET)
    _check(mask, jmask, **NET)
    _check(ae1, jae, **(dict(atol=2e-4, rtol=1e-3) if bilaplacian else NET))
    assert float((Ts1 - _t(Ts)).abs().max()) > 1e-4


def test_whole_model_matches_jax(pair):
    bilaplacian, variables, model = pair
    frame = _frame(10)
    jmodel = jraft.RAFT3D(bilaplacian=bilaplacian)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, iters=2))(
        variables, *map(jnp.asarray, frame))
    with torch.no_grad():
        got = model(*_torch_frame(frame), iters=2)
    assert got.shape == (1, H, W, 7)
    _check(got, want, **FIELD)
    norm = got[..., 3:].norm(dim=-1)
    assert float((norm - 1).abs().max()) < 1e-5


def test_train_mode_outputs_match_jax(pair):
    bilaplacian, variables, model = pair
    frame = _frame(11)
    jmodel = jraft.RAFT3D(bilaplacian=bilaplacian)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, iters=2,
                                              train_mode=True))(
        variables, *map(jnp.asarray, frame))
    with torch.no_grad():
        got = model(*_torch_frame(frame), iters=2, train_mode=True)
    assert [tuple(g.shape) for g in got] == [(2, 1, H, W, 3), (2, 1, H, W, 2),
                                             (2, 1, H, W, 7)]
    for g, w_ in zip(got, want):
        # Flows are in pixels of the full image: 8 x the field's tolerance.
        _check(g, w_, atol=4e-4, rtol=1e-4)


def test_field_is_detached_at_the_top_of_each_iteration():
    """Gradients reach the weights through the last iteration only as far
    as its own update: the carried field is cut, as in the JAX model."""
    model = traft.RAFT3D()
    traft.init_weights(model, torch.Generator().manual_seed(0))
    const, net = model.features(*_torch_frame(_frame(12)))
    Ts, net, ae = model.initial_carry(net)
    Ts = Ts.clone().requires_grad_(True)
    (Ts1, _, _), _ = model.iteration((Ts, net, ae), const)
    Ts1.sum().backward()
    assert Ts.grad is None
    grad = model.update_block.delta[2].weight.grad
    assert grad is not None and torch.isfinite(grad).all()


def test_bf16_model_keeps_the_field_float32_and_finite():
    model = traft.RAFT3D(dtype=torch.bfloat16).eval()
    traft.init_weights(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = model(*_torch_frame(_frame(13)), iters=2)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_stage_runs_on_the_cpu_and_defaults_to_the_card():
    from sndepth_tpu_torch.pipelines import RAFT3DStage
    stage = RAFT3DStage(iters=2, device="cpu", seed=3)
    Ts, tau_phi = stage(*_torch_frame(_frame(14)))
    assert Ts.shape == (1, H, W, 7) and tau_phi.shape == (1, H, W, 6)
    assert torch.isfinite(Ts).all() and torch.isfinite(tau_phi).all()
    again = RAFT3DStage(iters=2, device="cpu", seed=3)
    torch.testing.assert_close(again(*_torch_frame(_frame(14)))[0], Ts,
                               rtol=0, atol=0)
    loaded = RAFT3DStage(stage.model.state_dict(), iters=2, device="cpu")
    torch.testing.assert_close(loaded(*_torch_frame(_frame(14)))[0], Ts,
                               rtol=0, atol=0)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            RAFT3DStage(iters=1)


def test_benchmark_family_raft3d_on_the_cpu(capsys):
    from sndepth_tpu_torch.cli import benchmark
    result, = benchmark.main(["--family", "raft3d", "--iters", "1",
                              "--img_height", "64", "--img_width", "64",
                              "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert result["family"] == "raft3d" and result["unit"] == "frames/sec"
    # On a loaded machine a frame can take so long that frames/sec rounds
    # to 0.0 at the record's one decimal.
    assert result["ms_per_step"] > 0 and result["value"] >= 0
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            benchmark.main(["--family", "raft3d", "--iters", "1",
                            "--img_height", "64", "--img_width", "64"])
