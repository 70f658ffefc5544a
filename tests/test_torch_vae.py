"""The port's VAE / diffusion stack against the JAX package on the CPU, on
the same inputs and weights, made from a seed with numpy: the AutoencoderKL
at a narrow width and ``VAEStage`` at full width, the posterior and
``normal_kl``, the DDPM variants, the attention library and
``chunked_attention``, the pose denoiser, the ViT and its multi-scale
extractor, the antialiased resize at the ViT's shapes, the diffusion
schedules, and the ``predict_vae`` / ``testvae`` CLIs.

JAX parameters come from ``jax.eval_shape`` of each module's ``init`` and
numpy (kernels normal over sqrt(fan_in), biases and norm offsets 0.1
normal, norm scales 1 + 0.1 normal, the ViT's embeddings 0.02 normal) and
reach the port through ``vae_state_dict_from_jax``,
``vit_state_dict_from_jax`` and ``denoiser_state_dict_from_jax`` (the
library's blocks through the same helpers); the converters of the JAX
package carry them back. The posterior's draw takes the same noise on both
sides.

Tolerances: the networks atol 1e-4 + rtol 1e-4 (float32 convolutions and
GroupNorm in another order through up to ~20 layers; measured up to 2.8e-6
of the largest value); the attention blocks atol 2e-5 + rtol 1e-5 (float32
products of up to 256 terms, a softmax and LayerNorm; measured 4.5e-7); the posterior's statistics, KL and
NLL rtol 1e-5; the resize atol 1e-6 (a weighted sum of at most 9 taps with
weights formed in another order); the schedules bit for bit (the same
float64 numpy arithmetic). Every output is asserted finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sndepth_tpu.models import attention as jatt
from sndepth_tpu.models import denoiser as jden
from sndepth_tpu.models import vae as jvae
from sndepth_tpu.models import vit as jvit
from sndepth_tpu.utils import diffusion as jdiff
from sndepth_tpu.utils.convert_weights import convert_dino_vit, convert_vae
from sndepth_tpu_torch.models import attention as tatt
from sndepth_tpu_torch.models import denoiser as tden
from sndepth_tpu_torch.models import vae as tvae
from sndepth_tpu_torch.models import vit as tvit
from sndepth_tpu_torch.ops.resize import resize_bilinear_antialias
from sndepth_tpu_torch.utils import diffusion as tdiff
from sndepth_tpu_torch.utils import weights as tw
from sndepth_tpu_torch.utils.layout import to_nchw, to_nhwc
from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


NET = dict(atol=1e-4, rtol=1e-4)
BLOCK = dict(atol=2e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _check(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, **tol)


def _params(module, *args, seed=0, **kwargs):
    """numpy parameters of the shapes ``module.init`` makes."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            if len(leaf.shape) == 3 and path[-2].key == "out":
                fan_in = int(np.prod(leaf.shape[:2]))
            a = rng.randn(*leaf.shape) / np.sqrt(fan_in)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.randn(*leaf.shape)
        elif name in ("pos_embed", "cls"):
            a = 0.02 * rng.randn(*leaf.shape)
        else:
            a = 0.1 * rng.randn(*leaf.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _apply(module, params, *args, **kwargs):
    return module.apply({"params": params}, *args, **kwargs)


# ----------------------------------------------------------------------
# AutoencoderKL
# ----------------------------------------------------------------------

NARROW = jvae.VAEConfig(base_ch=32, ch_mult=(1, 2), num_res_blocks=1)
TNARROW = tvae.VAEConfig(base_ch=32, ch_mult=(1, 2), num_res_blocks=1)


@pytest.fixture(scope="module")
def narrow():
    """(JAX params of a narrow AutoencoderKL, the port's with them)."""
    x = jnp.zeros((1, 32, 32, 4))
    params = _params(jvae.AutoencoderKL(NARROW), x, jax.random.PRNGKey(1),
                     seed=1)
    model = tvae.AutoencoderKL(TNARROW).eval()
    model.load_state_dict(tw.vae_state_dict_from_jax(params, TNARROW))
    return params, model


def test_narrow_autoencoder_matches_jax(narrow):
    """Encode (the posterior's moments), decode, and the forward pass that
    decodes a draw, with the draw's noise handed across."""
    params, model = narrow
    rng = np.random.RandomState(2)
    x = rng.rand(2, 32, 32, 4).astype(np.float32)
    net = jvae.AutoencoderKL(NARROW)
    enc = jax.jit(lambda p, x: _apply(net, p, x, method=net.encode).mean)
    post = _apply(net, params, jnp.asarray(x), method=net.encode)
    noise = rng.randn(*post.mean.shape).astype(np.float32)
    z = post.mean + post.std * noise
    want_rec = jax.jit(lambda p, z: _apply(net, p, z, method=net.decode))(
        params, z)
    with torch.no_grad():
        tpost = model.encode(_t(to_nchw(x)))
        rec, tpost2 = model(_t(to_nchw(x)), noise=_t(to_nchw(noise)))
        mode_rec, _ = model(_t(to_nchw(x)))
        dec = model.decode(_t(to_nchw(np.asarray(post.mean))))
    for name in ("mean", "logvar", "std", "var"):
        _check(to_nhwc(getattr(tpost, name).numpy()),
               getattr(post, name), **NET)
    _check(to_nhwc(tpost.mean.numpy()), enc(params, jnp.asarray(x)), **NET)
    assert rec.shape == (2, 4, 32, 32) and tpost.mean.shape == (2, 4, 16, 16)
    _check(to_nhwc(rec.numpy()), want_rec, **NET)
    torch.testing.assert_close(tpost2.mean, tpost.mean)
    want_mode = jax.jit(lambda p, z: _apply(net, p, z, method=net.decode))(
        params, post.mean)
    _check(to_nhwc(mode_rec.numpy()), want_mode, **NET)
    _check(to_nhwc(dec.numpy()), want_mode, **NET)


def test_autoencoder_weights_round_trip_through_convert_vae(narrow):
    """The port's state_dict has the Stable-Diffusion names, and
    ``convert_vae`` gives the JAX params back bit for bit."""
    params, model = narrow
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    for key in ("encoder.down.0.block.0.conv1.weight",
                "encoder.down.0.downsample.conv.weight",
                "encoder.down.1.block.0.nin_shortcut.weight",
                "encoder.mid.attn_1.proj_out.bias", "encoder.norm_out.weight",
                "decoder.up.1.upsample.conv.weight",
                "decoder.up.0.block.1.norm2.bias", "decoder.mid.block_2.conv1.weight",
                "quant_conv.weight", "post_quant_conv.bias"):
        assert key in sd, key
    assert "decoder.up.0.upsample.conv.weight" not in sd
    back = convert_vae(sd, NARROW)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_vae_stage_matches_jax_at_full_width():
    """``VAEStage`` (the reference's autoencoder at full width) against the
    JAX stage at 16x32 on the same weights: the posterior's mean and
    variance, channel-last."""
    from sndepth_tpu import pipelines as jpipe
    from sndepth_tpu_torch import pipelines as tpipe
    net = jvae.get_autoencoder(dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k: net.init(k, jnp.zeros((1, 16, 32, 4)), method=net.encode),
        jax.random.PRNGKey(0))
    assert set(shapes["params"]) == {"encoder", "quant_conv"}
    params = _params(jvae.AutoencoderKL(), jnp.zeros((1, 16, 32, 4)),
                     jax.random.PRNGKey(1), seed=3)
    rng = np.random.RandomState(4)
    rgb = rng.rand(1, 16, 32, 3).astype(np.float32)
    depth = (1 + 9 * rng.rand(1, 16, 32)).astype(np.float32)
    jstage = jpipe.VAEStage(variables={"params": params},
                            sample_shape=(1, 16, 32))
    want_mean, want_var = jstage(jnp.asarray(rgb), jnp.asarray(depth))
    stage = tpipe.VAEStage(tw.vae_state_dict_from_jax(params), device="cpu")
    mean, var = stage(_t(to_nchw(rgb)), _t(depth))
    assert mean.shape == (1, 2, 4, 4)
    _check(mean, want_mean, **NET)
    _check(var, want_var, **NET)


def test_posterior_and_normal_kl_match_jax():
    """``kl`` (against the standard normal and another posterior), ``nll``,
    ``mode`` and the draw with given noise, the log-variance clipped to
    [-30, 20]; and ``normal_kl``."""
    rng = np.random.RandomState(5)
    m1, m2 = (rng.randn(3, 6, 5, 8).astype(np.float32) for _ in range(2))
    m1[0, 0, 0, 4:] = [-40.0, 25.0, 19.0, -29.0]
    noise = rng.randn(3, 6, 5, 4).astype(np.float32)
    sample = rng.randn(3, 6, 5, 4).astype(np.float32)
    j1, j2 = jvae.DiagonalGaussian(jnp.asarray(m1)), jvae.DiagonalGaussian(
        jnp.asarray(m2))
    t1, t2 = (tvae.DiagonalGaussian(_t(to_nchw(m))) for m in (m1, m2))
    tol = dict(atol=1e-6, rtol=1e-5)
    _check(t1.kl(), j1.kl(), **tol)
    _check(t1.kl(t2), j1.kl(j2), **tol)
    _check(t1.nll(_t(to_nchw(sample))), j1.nll(jnp.asarray(sample)), **tol)
    _check(to_nhwc(t1.mode().numpy()), j1.mode(), **tol)
    _check(to_nhwc(t1.logvar.numpy()), j1.logvar, **tol)
    assert float(t1.logvar.min()) == -30.0 and float(t1.logvar.max()) == 20.0
    _check(to_nhwc(t1.sample(_t(to_nchw(noise))).numpy()),
           j1.mean + j1.std * noise, **tol)
    g = t1.sample(generator=torch.Generator().manual_seed(0))
    assert g.shape == t1.mean.shape and torch.isfinite(g).all()
    a, b, c, d = (rng.randn(4, 7).astype(np.float32) for _ in range(4))
    _check(tvae.normal_kl(_t(a), _t(b), _t(c), _t(d)),
           jvae.normal_kl(a, b, c, d), **tol)


def _ddpm_map(name, params):
    """JAX params of a DDPM variant -> the port's state_dict."""
    sd: dict = {}
    if name == "unet":
        tw._dense(sd, "temb.dense.0", params["Dense_0"])
        tw._dense(sd, "temb.dense.1", params["Dense_1"])
        tw._conv(sd, "conv_in", params["Conv_0"])
        keys = ["down.0.block.0", "down.1.block.0", "mid.block_1",
                "mid.block_2", "up.1.block.0", "up.1.block.1",
                "up.0.block.0", "up.0.block.1"]
        for i, key in enumerate(keys):
            tw._resnet_block(sd, key, params[f"ResnetBlock_{i}"])
            tw._dense(sd, f"{key}.temb_proj",
                      params[f"ResnetBlock_{i}"]["temb_proj"])
        for i, key in enumerate(["down.1.attn.0", "mid.attn_1", "up.1.attn.0",
                                 "up.1.attn.1"]):
            tw._attn_block(sd, key, params[f"AttnBlock_{i}"])
        for i, key in enumerate(["down.0.downsample.conv",
                                 "up.1.upsample.conv", "conv_out"]):
            tw._conv(sd, key, params[f"Conv_{i + 1}"])
        tw._norm(sd, "norm_out", params["GroupNorm_0"])
    elif name == "simple":
        tw._conv(sd, "model.0", params["Conv_0"])
        for i in range(3):
            tw._resnet_block(sd, f"model.{i + 1}", params[f"ResnetBlock_{i}"])
        tw._conv(sd, "model.4", params["Conv_1"])
        tw._conv(sd, "model.5.conv", params["Conv_2"])
        tw._norm(sd, "norm_out", params["GroupNorm_0"])
        tw._conv(sd, "conv_out", params["Conv_3"])
    elif name == "upsample":
        for i in range(4):
            tw._resnet_block(sd, f"res_blocks.{i // 2}.{i % 2}",
                             params[f"ResnetBlock_{i}"])
        tw._conv(sd, "upsample_blocks.0.conv", params["Conv_0"])
        tw._norm(sd, "norm_out", params["GroupNorm_0"])
        tw._conv(sd, "conv_out", params["Conv_1"])
    else:
        tw._conv(sd, "conv_in", params["Conv_0"])
        tw._resnet_block(sd, "res_block1.0", params["ResnetBlock_0"])
        tw._attn_block(sd, "attn", params["AttnBlock_0"])
        tw._resnet_block(sd, "res_block2.0", params["ResnetBlock_1"])
        tw._conv(sd, "conv_out", params["Conv_1"])
    return sd


DDPM = {
    "unet": (lambda: jvae.DDPMUNet(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                                   attn_resolutions=(8,), resolution=16),
             lambda: tvae.DDPMUNet(5, ch=32, ch_mult=(1, 2),
                                   num_res_blocks=1, attn_resolutions=(8,),
                                   resolution=16), (16, 16, 3)),
    "simple": (lambda: jvae.SimpleDecoder(out_channels=3),
               lambda: tvae.SimpleDecoder(32, 3), (8, 12, 32)),
    "upsample": (lambda: jvae.UpsampleDecoder(out_channels=3, ch=32,
                                              num_res_blocks=1,
                                              ch_mult=(1, 2)),
                 lambda: tvae.UpsampleDecoder(32, 3, 32, 1, (1, 2)),
                 (8, 12, 32)),
    "rescaler": (lambda: jvae.LatentRescaler(factor=1.5, mid_channels=32,
                                             out_channels=4, depth=1),
                 lambda: tvae.LatentRescaler(1.5, 32, 32, 4, 1),
                 (6, 10, 32)),
}


@pytest.mark.parametrize("name", list(DDPM))
def test_ddpm_variants_match_jax(name):
    """The DDPM UNet (timestep and a 2-channel context, attention at 8x8),
    the simple and upsampling decoders and the latent rescaler (a 1.5x
    nearest resize)."""
    make_jax, make_torch, shape = DDPM[name]
    rng = np.random.RandomState(6)
    x = rng.randn(2, *shape).astype(np.float32)
    extra, textra = (), ()
    if name == "unet":
        t = np.array([3.0, 250.0], np.float32)
        ctx = rng.randn(2, *shape[:2], 2).astype(np.float32)
        extra = (jnp.asarray(t), jnp.asarray(ctx))
        textra = (_t(t), _t(to_nchw(ctx)))
    net = make_jax()
    params = _params(net, jnp.asarray(x), *extra, seed=7)
    want = jax.jit(lambda p, x, *e: _apply(net, p, x, *e))(
        params, jnp.asarray(x), *extra)
    model = make_torch().eval()
    model.load_state_dict(_ddpm_map(name, params))
    with torch.no_grad():
        got = model(_t(to_nchw(x)), *textra)
    _check(to_nhwc(got.numpy()), want, **NET)


# ----------------------------------------------------------------------
# Attention library
# ----------------------------------------------------------------------

def _cross(sd, key, p):
    for i, n in enumerate(("to_q", "to_k", "to_v", "to_out.0")):
        tw._dense(sd, f"{key}.{n}", p[f"Dense_{i}"])


def _ff(sd, key, p, gated=True):
    tw._dense(sd, f"{key}.net.0.proj" if gated else f"{key}.net.0.0",
              p["Dense_0"])
    tw._dense(sd, f"{key}.net.2", p["Dense_1"])


def _block(sd, key, p):
    """A JAX BasicTransformerBlock (auto-named) or BasicTransformerBlock21
    (named attn1, attn2, ff, norm1-3)."""
    if "attn1" in p:
        names = {"attn1": "attn1", "attn2": "attn2", "ff": "ff",
                 "norm1": "norm1", "norm2": "norm2", "norm3": "norm3"}
    else:
        names = {"CrossAttention_0": "attn1", "CrossAttention_1": "attn2",
                 "FeedForward_0": "ff", "LayerNorm_0": "norm1",
                 "LayerNorm_1": "norm2", "LayerNorm_2": "norm3"}
    for jname, tname in names.items():
        if tname.startswith("attn"):
            _cross(sd, f"{key}.{tname}", p[jname])
        elif tname == "ff":
            _ff(sd, f"{key}.ff", p[jname])
        else:
            tw._norm(sd, f"{key}.{tname}", p[jname])


def _transformer(sd, p, use_linear=False):
    tw._norm(sd, "norm", p["GroupNorm_0"])
    put = tw._dense if use_linear else tw._conv
    kind = "Dense" if use_linear else "Conv"
    put(sd, "proj_in", p[f"{kind}_0"])
    put(sd, "proj_out", p[f"{kind}_1"])
    blocks = sorted(k for k in p if k.startswith("BasicTransformerBlock"))
    for i, k in enumerate(blocks):
        _block(sd, f"transformer_blocks.{i}", p[k])


def _attention_case(kind, rng):
    """(JAX module, its inputs, the port's module, its inputs, the map of
    the JAX params to the port's state_dict, a function of the port's
    output giving the JAX layout)."""
    img = rng.randn(2, 6, 5, 32).astype(np.float32)
    seq = rng.randn(2, 7, 32).astype(np.float32)
    ctx = rng.randn(2, 4, 8).astype(np.float32)
    mask = np.array([[1, 1, 0, 1], [1, 0, 0, 0]], bool)
    ident = lambda y: y
    if kind == "linear":
        return (jatt.LinearAttention(), (img,), tatt.LinearAttention(32),
                (to_nchw(img),), lambda p, sd: [tw._conv(sd, "to_qkv",
                                                         p["Conv_0"]),
                                                tw._conv(sd, "to_out",
                                                         p["Conv_1"])],
                to_nhwc)
    if kind == "cross_masked":
        return (jatt.CrossAttention(heads=2, dim_head=16), (seq, ctx, mask),
                tatt.CrossAttention(32, 8, heads=2, dim_head=16),
                (seq, ctx, mask), lambda p, sd: _cross(sd, "m", p), ident)
    if kind == "spatial_self":
        return (jatt.SpatialSelfAttention(), (img,),
                tatt.SpatialSelfAttention(32), (to_nchw(img),),
                lambda p, sd: tw._attn_block(sd, "m", p["AttnBlock_0"]),
                to_nhwc)
    if kind in ("ff_gated", "ff_plain"):
        gated = kind == "ff_gated"
        return (jatt.FeedForward(gated=gated), (seq,),
                tatt.FeedForward(32, gated=gated), (seq,),
                lambda p, sd: _ff(sd, "m", p, gated), ident)
    if kind == "block":
        return (jatt.BasicTransformerBlock(heads=2, dim_head=16), (seq, ctx),
                tatt.BasicTransformerBlock(32, 2, 16, context_dim=8),
                (seq, ctx), lambda p, sd: _block(sd, "m", p), ident)
    if kind == "block21_no_self":
        return (jatt.BasicTransformerBlock21(heads=2, dim_head=16,
                                             disable_self_attn=True),
                (seq, ctx),
                tatt.BasicTransformerBlock21(32, 2, 16, context_dim=8,
                                             disable_self_attn=True),
                (seq, ctx), lambda p, sd: _block(sd, "m", p), ident)
    if kind == "spatial":
        return (jatt.SpatialTransformer(heads=2, dim_head=16), (img, ctx),
                tatt.SpatialTransformer(32, 2, 16, context_dim=8),
                (to_nchw(img), ctx),
                lambda p, sd: _transformer(sd, p), to_nhwc)
    if kind in ("spatial21_linear", "spatial21_conv"):
        linear = kind == "spatial21_linear"
        ctx2 = rng.randn(2, 3, 8).astype(np.float32)
        return (jatt.SpatialTransformer21(heads=2, dim_head=16, depth=2,
                                          use_linear=linear),
                (img, [ctx, ctx2]),
                tatt.SpatialTransformer21(32, 2, 16, depth=2, context_dim=8,
                                          use_linear=linear),
                (to_nchw(img), [ctx, ctx2]),
                lambda p, sd: _transformer(sd, p, linear), to_nhwc)
    # The cross-frame transformer: 2 clips of 2 frames.
    return (jatt.SpatialTransformer3D(frames=2, heads=2, dim_head=16),
            (rng.randn(4, 3, 5, 32).astype(np.float32),),
            tatt.SpatialTransformer3D(32, 2, 2, 16), None,
            lambda p, sd: _transformer(sd, p), to_nhwc)


ATTENTION = ["linear", "cross_masked", "spatial_self", "ff_gated",
             "ff_plain", "block", "block21_no_self", "spatial",
             "spatial21_linear", "spatial21_conv", "spatial3d"]


@pytest.mark.parametrize("kind", ATTENTION)
def test_attention_blocks_match_jax(kind):
    rng = np.random.RandomState(8)
    jmod, jargs, tmod, targs, fill, layout = _attention_case(kind, rng)
    if targs is None:
        targs = (to_nchw(jargs[0]),)
    conv = lambda a: (jnp.asarray(a) if not isinstance(a, list)
                      else [jnp.asarray(x) for x in a])
    params = _params(jmod, *map(conv, jargs), seed=9)
    want = jmod.apply({"params": params}, *map(conv, jargs))
    sd: dict = {}
    fill(params, sd)
    if kind in ("cross_masked", "spatial_self", "ff_gated", "ff_plain",
                "block", "block21_no_self"):
        sd = {k[2:]: v for k, v in sd.items()}
    tmod.eval().load_state_dict(sd)

    def tconv(a):
        if isinstance(a, list):
            return [_t(x) for x in a]
        return torch.from_numpy(a) if a.dtype == bool else _t(a)

    with torch.no_grad():
        got = tmod(*map(tconv, targs))
    _check(layout(got.numpy()), want, **BLOCK)
    # The output is not the residual alone.
    if kind.startswith("spatial") and kind != "spatial_self":
        assert np.abs(np.asarray(want) - jargs[0]).max() > 1e-2


def test_spatial_transformer_starts_as_the_identity():
    """A freshly built spatial transformer's output projection is zero, as
    the JAX module's ``kernel_init``: it returns its input."""
    x = torch.randn(2, 32, 4, 5, generator=torch.Generator().manual_seed(0))
    for m in (tatt.SpatialTransformer(32, 2, 16),
              tatt.SpatialTransformer21(32, 2, 16, use_linear=True)):
        with torch.no_grad():
            assert torch.equal(m(x), x)


def test_chunked_attention_matches_dense_and_jax():
    """Query blocks of 16 over 37 queries (a ragged last block) against the
    dense form (one block) and the JAX function, with and without a key
    mask."""
    rng = np.random.RandomState(10)
    q = rng.randn(2, 37, 3, 8).astype(np.float32)
    k, v = (rng.randn(2, 29, 3, 8).astype(np.float32) for _ in range(2))
    mask = rng.rand(2, 29) > 0.3
    for m in (None, mask):
        tm = None if m is None else torch.from_numpy(m)
        got = tatt.chunked_attention(_t(q), _t(k), _t(v), chunk=16, mask=tm)
        dense = tatt.chunked_attention(_t(q), _t(k), _t(v), chunk=1024,
                                       mask=tm)
        want = jatt.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), chunk=16,
                                      mask=None if m is None
                                      else jnp.asarray(m))
        assert torch.equal(got, dense)
        _check(got, want, atol=1e-6, rtol=1e-5)


# ----------------------------------------------------------------------
# Denoiser, ViT, resize, schedules
# ----------------------------------------------------------------------

def test_embeddings_match_jax():
    """The timestep embedding at atol 1e-4: its frequencies come from
    ``exp`` in float32, an ulp apart between the two libraries, and at
    t = 999 an ulp of a frequency moves the phase by ~1e-4 (1e-6 at
    t <= 17); the harmonic embedding at 1e-5."""
    t = np.array([0.0, 1.0, 17.0, 999.0], np.float32)
    for dim in (256, 7):
        got = tden.timestep_embedding(_t(t), dim)
        want = jden.timestep_embedding(jnp.asarray(t), dim)
        _check(got, want, atol=1e-4, rtol=0)
        _check(got[:3], np.asarray(want)[:3], atol=1e-6, rtol=1e-5)
    x = np.random.RandomState(11).randn(2, 3, 9).astype(np.float32)
    _check(tden.harmonic_embedding(_t(x)), jden.harmonic_embedding(
        jnp.asarray(x)), atol=1e-5, rtol=1e-5)
    assert tden.harmonic_embedding(_t(x)).shape[-1] == tden.harmonic_out_dim(9)


def test_denoiser_matches_jax():
    """A 2-layer Denoiser at the reference's widths (d 512, 4 heads,
    feed-forward 1024, features 384, pivot one-hot)."""
    rng = np.random.RandomState(12)
    x = rng.randn(2, 5, 9).astype(np.float32)
    t = np.array([10.0, 400.0], np.float32)
    z = rng.randn(2, 5, 384).astype(np.float32)
    net = jden.Denoiser(num_layers=2)
    params = _params(net, jnp.asarray(x), jnp.asarray(t), jnp.asarray(z),
                     seed=13)
    want = jax.jit(lambda p, *a: _apply(net, p, *a))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(z))
    model = tden.Denoiser(num_layers=2).eval()
    model.load_state_dict(tw.denoiser_state_dict_from_jax(params))
    with torch.no_grad():
        got = model(_t(x), _t(t), _t(z))
    assert got.dtype == torch.float32
    _check(got, want, **NET)
    full = tden.get_opt_model()
    assert len(full._trunk.layers) == 8
    assert full._first.in_features == 189 + 128 + 385


VIT_DEPTH = 2


@pytest.fixture(scope="module")
def vit_pair():
    net = jvit.ViT(depth=VIT_DEPTH)
    params = _params(net, jnp.zeros((1, 128, 416, 3)), seed=14)
    model = tvit.ViT(depth=VIT_DEPTH).eval()
    model.load_state_dict(tw.vit_state_dict_from_jax(params))
    return params, model


def test_vit_matches_jax_and_round_trips_through_convert_dino_vit(vit_pair):
    """A 2-block ViT-S/16 at 128x416 (an 8x26 token grid: the position
    grid shrinks in one axis and grows in the other); its state_dict has
    DINO's names and goes back through ``convert_dino_vit`` bit for bit."""
    params, model = vit_pair
    x = np.random.RandomState(15).rand(2, 128, 416, 3).astype(np.float32)
    want = jax.jit(lambda p, x: _apply(jvit.ViT(depth=VIT_DEPTH), p, x))(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = model(_t(to_nchw(x)))
    _check(got, want, **NET)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert {"cls_token", "pos_embed", "patch_embed.proj.weight",
            "blocks.1.attn.qkv.weight", "blocks.0.mlp.fc2.bias",
            "norm.weight"} <= set(sd)
    back = convert_dino_vit(sd, depth=VIT_DEPTH)
    got_p = dict(jax.tree_util.tree_leaves_with_path(back))
    want_p = dict(jax.tree_util.tree_leaves_with_path(params))
    assert set(got_p) == set(want_p)
    for path, leaf in want_p.items():
        np.testing.assert_array_equal(got_p[path], leaf)


def test_multiscale_extractor_matches_jax(vit_pair):
    """ImageNet normalisation and the class feature averaged over 128x416,
    64x208 and 32x128 (the antialiased shrinks by 1/2 and 1/3)."""
    params, model = vit_pair

    class Small(jvit.MultiScaleImageFeatureExtractor):
        def setup(self):
            self.net = jvit.ViT(depth=VIT_DEPTH)

    x = np.random.RandomState(16).rand(1, 128, 416, 3).astype(np.float32)
    want = jax.jit(lambda p, x: Small().apply({"params": {"net": p}}, x))(
        params, jnp.asarray(x))
    extractor = tvit.MultiScaleImageFeatureExtractor().eval()
    extractor.net = model
    with torch.no_grad():
        got = extractor(_t(to_nchw(x)))
    assert got.shape == (1, 384)
    _check(got, want, **NET)


@pytest.mark.parametrize("src,dst", [((14, 14), (8, 26)), ((14, 14), (8, 8)),
                                     ((14, 14), (26, 40)),
                                     ((128, 416), (64, 208)),
                                     ((128, 416), (32, 128)),
                                     ((37, 50), (16, 16))])
def test_antialiased_resize_matches_jax_image_resize(src, dst):
    """``resize_bilinear_antialias`` against ``jax.image.resize(...,
    "bilinear")`` (antialiased by default) at the ViT's shapes: its
    position grid to 8x26 and the extractor's 1/2 and 1/3 scales."""
    x = np.random.RandomState(17).randn(2, 3, *src).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 3, *dst), method="bilinear")
    got = resize_bilinear_antialias(_t(x), *dst)
    _check(got, want, atol=1e-6, rtol=1e-6)


def test_schedules_match_jax():
    for schedule in ("linear", "cosine", "sqrt_linear", "sqrt"):
        np.testing.assert_array_equal(tdiff.make_beta_schedule(schedule, 50),
                                      jdiff.make_beta_schedule(schedule, 50))
    with pytest.raises(ValueError):
        tdiff.make_beta_schedule("nope", 10)
    alphas = np.cumprod(1 - tdiff.make_beta_schedule("linear", 1000))
    for method in ("uniform", "quad"):
        ts = tdiff.make_ddim_timesteps(method, 50, 1000)
        np.testing.assert_array_equal(
            ts, jdiff.make_ddim_timesteps(method, 50, 1000))
        for a, b in zip(tdiff.make_ddim_sampling_parameters(alphas, ts, 0.5),
                        jdiff.make_ddim_sampling_parameters(alphas, ts, 0.5)):
            np.testing.assert_array_equal(a, b)
    t = np.array([0, 5, 999])
    got = tdiff.extract_into_tensor(alphas, torch.from_numpy(t), (3, 4, 8, 8))
    want = jdiff.extract_into_tensor(alphas, jnp.asarray(t), (3, 4, 8, 8))
    assert got.shape == (3, 1, 1, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------

def test_predict_vae_joins_its_stages_as_jax_does(tmp_path, monkeypatch):
    """``predict_vae`` against the JAX CLI, every stage a stub that records
    what it is handed and returns the same numpy values: NNET gets GeoNet's
    depth and the image in [0, 1], the VAE that image and NNET's refined
    depth; the saved latents are equal."""
    from sndepth_tpu import pipelines as jpipe
    from sndepth_tpu.cli import predict_vae as jpredict_vae
    from sndepth_tpu_torch import pipelines as tpipe
    from sndepth_tpu_torch.cli import predict_vae
    h, w = 16, 24
    rng = np.random.RandomState(18)
    outs = [{"depth": (1 + rng.rand(1, h, w)).astype(np.float32),
             "tgt": rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32),
             "refined": (1 + rng.rand(1, h, w, 1)).astype(np.float32),
             "mean": rng.randn(1, 2, 3, 4).astype(np.float32)}
            for _ in range(2)]
    seen = {"jax": [], "torch": []}
    for side, mod, arr, nchw, nhwc in (
            ("jax", jpipe, jnp.asarray, jnp.asarray, lambda x: x),
            ("torch", tpipe, torch.from_numpy,
             lambda a: torch.from_numpy(a).permute(0, 3, 1, 2),
             lambda x: x.permute(0, 2, 3, 1))):
        rec = seen[side]

        class Stage:
            def __init__(self, *args, **kwargs):
                pass

        class GeoNet(Stage):
            def __call__(self, batch, rec=rec, arr=arr, nchw=nchw):
                rec.append({})
                o = outs[len(rec) - 1]
                return {"depth": arr(o["depth"]), "tgt_norm": nchw(o["tgt"])}

        class NNET(Stage):
            def __call__(self, pre_depth, rgb, rec=rec, arr=arr, nhwc=nhwc):
                rec[-1].update(pre_depth=np.asarray(pre_depth),
                               rgb=np.asarray(nhwc(rgb)))
                return {"depth": arr(outs[len(rec) - 1]["refined"])}

        class VAE(Stage):
            def __call__(self, rgb01, depth, rec=rec, arr=arr, nhwc=nhwc):
                rec[-1].update(vae_rgb=np.asarray(nhwc(rgb01)),
                               vae_depth=np.asarray(depth))
                m = arr(outs[len(rec) - 1]["mean"])
                return m, m

        for name, stub in (("GeoNetStage", GeoNet), ("NNETStage", NNET),
                           ("VAEStage", VAE)):
            monkeypatch.setattr(mod, name, stub)
    argv = ["--img_height", str(h), "--img_width", str(w), "--max_batches",
            "2"]
    jpredict_vae.main(argv + ["--out_dir", str(tmp_path / "jax")])
    out = predict_vae.main(argv + ["--out_dir", str(tmp_path / "torch"),
                                   "--device", "cpu"])
    assert len(out) == len(seen["jax"]) == len(seen["torch"]) == 2
    for i, (got, want) in enumerate(zip(seen["torch"], seen["jax"])):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(
            np.load(tmp_path / "torch" / f"latent_mean_{i}.npy"),
            np.load(tmp_path / "jax" / f"latent_mean_{i}.npy"))


def test_predict_vae_and_testvae_run_on_the_cpu(tmp_path, capsys):
    """Both CLIs at full width on the CPU at 32x64: finite latents of
    shape (1, 4, 8) channel-last, and the posterior shapes printed."""
    from sndepth_tpu_torch.cli import predict_vae, testvae
    out = predict_vae.main(["--img_height", "32", "--img_width", "64",
                            "--out_dir", str(tmp_path), "--device", "cpu"])
    mean = np.load(out[0]["path"])
    assert mean.shape == (1, 4, 8, 4) and np.isfinite(mean).all()
    res = testvae.main(["--batch", "2", "--height", "32", "--width", "64",
                        "--device", "cpu"])
    assert res["mean"].shape == res["var"].shape == (2, 4, 4, 8)
    assert bool((res["var"] > 0).all())
    text = capsys.readouterr().out
    assert "posterior mean: (2, 4, 4, 8)" in text
    assert "posterior var: (2, 4, 4, 8)" in text
