"""Carry JAX parameters of ``sndepth_tpu`` into the port's state_dicts.

The inverse of ``sndepth_tpu/utils/convert_weights.py``
(:func:`convert_dispnet`, :func:`convert_flownet`,
:func:`convert_posenet`, :func:`convert_raft3d`,
:func:`convert_efficientnet`, :func:`convert_normal_decoder`,
:func:`convert_motionfusion`, :func:`convert_raft2d_large`,
:func:`convert_vae`, :func:`convert_dino_vit`, :func:`convert_uniad`), and
the same for the JAX nets with no converter (RAFT2D, the pose denoiser).
Parameters come in as nested dicts of numpy arrays. Conv kernels (kh, kw, in, out) become (out, in, kh, kw);
ConvTranspose kernels become (in, out, kh, kw) by a plain transpose, because
the JAX ``TorchConvTranspose2x`` flips its taps at apply time, except
MotionFusionNet's head, whose taps flax stores flipped. Flax ``_UpConv_i`` /
``_IConv_i`` are torch level ``7 - i``; heads ``Conv_0..3`` are ``predict_disp4..1`` (DispNetS) or ``flow4..1``
(FlowNet).
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _t(a, axes) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(axes)))


def _b(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _conv(sd: dict, key: str, p: dict) -> None:
    sd[f"{key}.weight"] = _t(p["kernel"], (3, 2, 0, 1))
    if "bias" in p:
        sd[f"{key}.bias"] = _b(p["bias"])


def _encoder_decoder(params: dict) -> dict:
    sd: dict = {}
    for i in range(7):
        blk = params[f"_DownBlock_{i}"]
        _conv(sd, f"conv{i + 1}.0", blk["Conv_0"])
        _conv(sd, f"conv{i + 1}.2", blk["Conv_1"])
    for i in range(7):
        t = 7 - i
        up = params[f"_UpConv_{i}"]["TorchConvTranspose2x_0"]
        sd[f"upconv{t}.0.weight"] = _t(up["kernel"], (2, 3, 0, 1))
        sd[f"upconv{t}.0.bias"] = _b(up["bias"])
        _conv(sd, f"iconv{t}.0", params[f"_IConv_{i}"]["Conv_0"])
    return sd


def dispnet_state_dict_from_jax(params: dict) -> dict:
    """JAX DispNetS params -> :class:`DispNetS` state_dict."""
    sd = _encoder_decoder(params)
    for flax_idx, t in enumerate((4, 3, 2, 1)):
        _conv(sd, f"predict_disp{t}.0", params[f"Conv_{flax_idx}"])
    return sd


def flownet_state_dict_from_jax(params: dict) -> dict:
    """JAX FlowNet params -> :class:`FlowNet` state_dict."""
    sd = _encoder_decoder(params)
    for flax_idx, t in enumerate((4, 3, 2, 1)):
        _conv(sd, f"flow{t}", params[f"Conv_{flax_idx}"])
    return sd


def dispnet_alt_state_dict_from_jax(params: dict) -> dict:
    """JAX ``dispnet_alt.DispNet`` params -> :class:`~sndepth_tpu_torch.
    models.dispnet_alt.DispNet` state_dict: ``Conv_0..6`` the encoder, then
    in the order flax creates them ``TorchConvTranspose2x_i`` (upconv
    ``7 - i``), the iconvs ``Conv_7..10, 12, 14, 16`` and the heads
    ``Conv_11, 13, 15, 17`` (predict_disp4..1)."""
    sd: dict = {}
    for i in range(7):
        _conv(sd, f"conv{i + 1}.0", params[f"Conv_{i}"])
        t = 7 - i
        up = params[f"TorchConvTranspose2x_{i}"]
        sd[f"upconv{t}.0.weight"] = _t(up["kernel"], (2, 3, 0, 1))
        sd[f"upconv{t}.0.bias"] = _b(up["bias"])
    for t, idx in zip(range(7, 0, -1), (7, 8, 9, 10, 12, 14, 16)):
        _conv(sd, f"iconv{t}.0", params[f"Conv_{idx}"])
    for t, idx in zip((4, 3, 2, 1), (11, 13, 15, 17)):
        _conv(sd, f"predict_disp{t}.0", params[f"Conv_{idx}"])
    return sd


def dispunet_state_dict_from_jax(params: dict) -> dict:
    """JAX ``dispnet_alt.DispUNet`` params -> :class:`~sndepth_tpu_torch.
    models.dispnet_alt.DispUNet` state_dict: ``Conv_i`` the downs and
    ``Conv_n`` the output, ``GroupNorm_0..n-2`` the downs' norms, then
    ``TorchConvTranspose2x_k`` and ``GroupNorm_{n-1+k}`` the ups from the
    bottleneck (up ``n-1-k``)."""
    n = sum(1 for k in params if k.startswith("TorchConvTranspose2x_"))
    sd: dict = {}
    for i in range(n):
        _conv(sd, f"down{i}", params[f"Conv_{i}"])
        if i != n - 1:
            _norm(sd, f"down_norm{i}", params[f"GroupNorm_{i}"])
    for k in range(n):
        i = n - 1 - k
        up = params[f"TorchConvTranspose2x_{k}"]
        sd[f"up{i}.weight"] = _t(up["kernel"], (2, 3, 0, 1))
        sd[f"up{i}.bias"] = _b(up["bias"])
        if i > 0:
            _norm(sd, f"up_norm{i}", params[f"GroupNorm_{n - 1 + k}"])
    _conv(sd, "out", params[f"Conv_{n}"])
    return sd


def posenet_state_dict_from_jax(params: dict) -> dict:
    """JAX PoseNet params -> :class:`PoseNet` state_dict."""
    sd: dict = {}
    for i in range(7):
        _conv(sd, f"conv{i + 1}.0", params[f"Conv_{i}"])
    _conv(sd, "pred_poses", params["Conv_7"])
    return sd


def _bn(sd: dict, key: str, p: dict, stats: dict) -> None:
    sd[f"{key}.weight"] = _b(p["scale"])
    sd[f"{key}.bias"] = _b(p["bias"])
    sd[f"{key}.running_mean"] = _b(stats["mean"])
    sd[f"{key}.running_var"] = _b(stats["var"])
    sd[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


# ResNet-50: (torch layer number, blocks); the JAX _Bottleneck_i count on.
_RESNET50 = ((1, 3), (2, 4), (3, 6), (4, 3))


def _basic_encoder(sd: dict, prefix: str, p: dict) -> None:
    """A JAX ``BasicEncoder``: ``Conv_0`` / ``Conv_1`` are ``conv1`` /
    ``conv2``, ``_ResBlock_{0..5}`` are ``layer{1,2,3}.{0,1}`` with
    ``Conv_2`` the ``downsample.0``."""
    _conv(sd, f"{prefix}.conv1", p["Conv_0"])
    _conv(sd, f"{prefix}.conv2", p["Conv_1"])
    for bi in range(6):
        blk = p[f"_ResBlock_{bi}"]
        t = f"{prefix}.layer{bi // 2 + 1}.{bi % 2}"
        _conv(sd, f"{t}.conv1", blk["Conv_0"])
        _conv(sd, f"{t}.conv2", blk["Conv_1"])
        if "Conv_2" in blk:
            _conv(sd, f"{t}.downsample.0", blk["Conv_2"])


def raft3d_state_dict_from_jax(params: dict, batch_stats: dict) -> dict:
    """JAX RAFT3D variables -> :class:`RAFT3D` state_dict, for the plain
    and the bilaplacian variant (which has ``ae_enc`` and ``ae_wts``).

    ``BasicEncoder_0``: ``Conv_0`` / ``Conv_1`` are ``fnet.conv1`` /
    ``fnet.conv2``, ``_ResBlock_{0..5}`` are ``fnet.layer{1,2,3}.{0,1}``
    with ``Conv_2`` the ``downsample.0``. ``FPNContext_0``: ``Conv_0`` and
    ``BatchNorm_0`` are ``cnet.conv1`` / ``cnet.bn1``, ``_Bottleneck_i`` the
    blocks of ``cnet.layer{1..4}`` in order (``Conv_3`` / ``BatchNorm_3``
    the ``downsample.{0,1}``), ``Conv_{1,2,3}`` are ``cnet.uconv{1,2,3}``.
    The update block: ``Conv_{0,1,2}`` are ``corr_enc.{0,2,4}``,
    ``Conv_{3,4}`` are ``flow_enc.{0,2}``, ``ConvGRU_0.conv{g}_{i}`` are
    ``gru.conv{g}{i}``, ``{head}_{0,1}`` are ``{head}.{0,2}``."""
    sd: dict = {}
    _basic_encoder(sd, "fnet", params["BasicEncoder_0"])

    cnet, stats = params["FPNContext_0"], batch_stats["FPNContext_0"]
    _conv(sd, "cnet.conv1", cnet["Conv_0"])
    _bn(sd, "cnet.bn1", cnet["BatchNorm_0"], stats["BatchNorm_0"])
    bi = 0
    for layer, blocks in _RESNET50:
        for i in range(blocks):
            blk, bst = cnet[f"_Bottleneck_{bi}"], stats[f"_Bottleneck_{bi}"]
            t = f"cnet.layer{layer}.{i}"
            for ci in range(3):
                _conv(sd, f"{t}.conv{ci + 1}", blk[f"Conv_{ci}"])
                _bn(sd, f"{t}.bn{ci + 1}", blk[f"BatchNorm_{ci}"],
                    bst[f"BatchNorm_{ci}"])
            if "Conv_3" in blk:
                _conv(sd, f"{t}.downsample.0", blk["Conv_3"])
                _bn(sd, f"{t}.downsample.1", blk["BatchNorm_3"],
                    bst["BatchNorm_3"])
            bi += 1
    for i in (1, 2, 3):
        _conv(sd, f"cnet.uconv{i}", cnet[f"Conv_{i}"])

    ub = params["Scan_RAFTIteration_0"]["BasicUpdateBlock_0"]
    for flax_idx, key in enumerate(("corr_enc.0", "corr_enc.2", "corr_enc.4",
                                    "flow_enc.0", "flow_enc.2")):
        _conv(sd, f"update_block.{key}", ub[f"Conv_{flax_idx}"])
    for gate in "zrq":
        for i in (1, 2):
            _conv(sd, f"update_block.gru.conv{gate}{i}",
                  ub["ConvGRU_0"][f"conv{gate}_{i}"])
    heads = ["ae", "mask", "delta", "weight"]
    if "ae_enc" in ub:
        _conv(sd, "update_block.ae_enc", ub["ae_enc"])
        heads.append("ae_wts")
    for head in heads:
        _conv(sd, f"update_block.{head}.0", ub[f"{head}_0"])
        _conv(sd, f"update_block.{head}.2", ub[f"{head}_1"])
    return sd


def _efficientnet(sd: dict, prefix: str, params: dict, stats: dict) -> None:
    """EfficientNet encoder params -> timm's names under ``prefix``. A
    block with ``Conv_2`` is an inverted residual (conv_pw, conv_dw,
    conv_pwl), one without it a depthwise-separable block (conv_dw,
    conv_pw); depthwise kernels (k, k, 1, C) take the plain transpose."""
    _conv(sd, f"{prefix}conv_stem", params["Conv_0"])
    _bn(sd, f"{prefix}bn1", params["BatchNorm_0"], stats["BatchNorm_0"])
    blocks = sorted((k for k in params if k.startswith("stage")),
                    key=lambda k: tuple(map(int, k[5:].split("_block"))))
    for name in blocks:
        si, ri = name[5:].split("_block")
        t = f"{prefix}blocks.{si}.{ri}"
        p, st = params[name], stats[name]
        se = p["SqueezeExcite_0"]
        _conv(sd, f"{t}.se.conv_reduce", se["Conv_0"])
        _conv(sd, f"{t}.se.conv_expand", se["Conv_1"])
        if "Conv_2" in p:
            convs = ("conv_pw", "conv_dw", "conv_pwl")
        else:
            convs = ("conv_dw", "conv_pw")
        for i, conv in enumerate(convs):
            _conv(sd, f"{t}.{conv}", p[f"Conv_{i}"])
            _bn(sd, f"{t}.bn{i + 1}", p[f"BatchNorm_{i}"],
                st[f"BatchNorm_{i}"])
    _conv(sd, f"{prefix}conv_head", params["Conv_1"])
    _bn(sd, f"{prefix}bn2", params["BatchNorm_1"], stats["BatchNorm_1"])


def _normal_decoder(sd: dict, prefix: str, params: dict,
                    stats: dict | None) -> None:
    """Normal decoder params (either architecture) -> the reference's
    names under ``prefix``; a Dense (in, out) becomes a kernel-1 Conv1d
    (out, in, 1)."""
    _conv(sd, f"{prefix}conv2", params["Conv_0"])
    for bi in range(4):
        p = params[f"UpSampleBlock_{bi}"]
        t = f"{prefix}up{bi + 1}._net"
        for i, idx in enumerate((0, 3)):
            if f"WSConv_{i}" in p:
                _conv(sd, f"{t}.{idx}", p[f"WSConv_{i}"])
                gn = p[f"GroupNorm_{i}"]
                sd[f"{t}.{idx + 1}.weight"] = _b(gn["scale"])
                sd[f"{t}.{idx + 1}.bias"] = _b(gn["bias"])
            else:
                _conv(sd, f"{t}.{idx}", p[f"Conv_{i}"])
                _bn(sd, f"{t}.{idx + 1}", p[f"BatchNorm_{i}"],
                    stats[f"UpSampleBlock_{bi}"][f"BatchNorm_{i}"])
    _conv(sd, f"{prefix}out_conv_res8", params["Conv_1"])
    for r in (4, 2, 1):
        mlp = params[f"out_conv_res{r}"]
        for j, idx in enumerate((0, 2, 4, 6)):
            dense = mlp[f"Dense_{j}"]
            sd[f"{prefix}out_conv_res{r}.{idx}.weight"] = _t(
                dense["kernel"], (1, 0))[..., None]
            sd[f"{prefix}out_conv_res{r}.{idx}.bias"] = _b(dense["bias"])


# The refiner's convolution stacks, in the JAX module's names.
_REFINER_STACKS = ("noise_enc1", "noise_enc2", "norm_fusion",
                   "depth_fusion", "edge_encoder", "edge_weight")


def nnet_state_dict_from_jax(params: dict, batch_stats: dict) -> dict:
    """JAX NNET variables (``params`` and ``batch_stats`` with ``encoder``,
    ``decoder`` and ``refiner`` subtrees) -> :class:`NNET` state_dict.

    The encoder's keys (under ``encoder.``) are timm's and the decoder's
    (under ``decoder.``) the reference's, so that ``convert_efficientnet``
    and ``convert_normal_decoder`` map them back unchanged; the refiner's
    ``{stack}.Conv_i`` are ``refiner.{stack}.{2 i}``."""
    sd: dict = {}
    _efficientnet(sd, "encoder.", params["encoder"], batch_stats["encoder"])
    _normal_decoder(sd, "decoder.", params["decoder"],
                    batch_stats.get("decoder"))
    for stack in _REFINER_STACKS:
        p = params["refiner"][stack]
        for i in range(len(p)):
            _conv(sd, f"refiner.{stack}.{2 * i}", p[f"Conv_{i}"])
    return sd


def normalnet_state_dict_from_jax(params: dict, batch_stats: dict) -> dict:
    """JAX ``NormalNet`` variables (``EfficientNetEncoder_0`` and
    ``NormalDecoder_0`` subtrees) -> :class:`~sndepth_tpu_torch.train.nnet.
    NormalNet` state_dict, under the ``encoder.`` and ``decoder.`` names of
    :func:`nnet_state_dict_from_jax`."""
    sd: dict = {}
    _efficientnet(sd, "encoder.", params["EfficientNetEncoder_0"],
                  batch_stats["EfficientNetEncoder_0"])
    _normal_decoder(sd, "decoder.", params["NormalDecoder_0"],
                    batch_stats.get("NormalDecoder_0"))
    return sd


def _conv_bn(sd: dict, conv: str, bn: str, p: dict, stats: dict,
             i: int) -> None:
    _conv(sd, conv, p[f"Conv_{i}"])
    _bn(sd, bn, p[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"])


def _residual_unit(sd: dict, t: str, spec, p: dict, stats: dict) -> None:
    """One ``ResidualUnit``: ``Conv_i`` / ``BatchNorm_i`` in the order the
    JAX unit makes them, the shortcut's last."""
    if spec.branch_dilations is None:
        names = [(f"{t}.layer_1.{j}", f"{t}.layer_1.{j + 1}")
                 for j in (0, 3, 6)]
        if spec.project:
            names.append((f"{t}.layer_2.0", f"{t}.layer_2.1"))
    else:
        names = [(f"{t}.{n}.0", f"{t}.{n}.1") for n in (
            "initial_conv", "branch1", "branch2", "final_conv")]
        if spec.project:
            names.append((f"{t}.down_conv.0", f"{t}.down_conv.1"))
    for i, (conv, bn) in enumerate(names):
        _conv_bn(sd, conv, bn, p, stats, i)


def motionfusion_state_dict_from_jax(params: dict, batch_stats: dict
                                     ) -> dict:
    """JAX ``MotionFusionNet`` variables -> :class:`~sndepth_tpu_torch.
    models.motionseg.MotionFusionNet` state_dict, in the reference's names
    (what ``convert_motionfusion`` reads). The head's flax kernel (16, 16,
    in, out) holds its taps flipped: it becomes (in, out, 16, 16) flipped
    back."""
    from sndepth_tpu_torch.models.motionseg import (FUSION_UNITS,
                                                    MOTION_UNITS,
                                                    SEMANTIC_UNITS)
    sd: dict = {}
    for tower, jname, units, layer1 in (
            ("motionFeatureNet", "MotionFeatureNet_0", MOTION_UNITS, (0,)),
            ("semanticFeatureNet", "SemanticFeatureNet_0", SEMANTIC_UNITS,
             (0, 3))):
        p, st = params[jname], batch_stats[jname]
        for i, j in enumerate(layer1):
            _conv_bn(sd, f"{tower}.layer1.{j}", f"{tower}.layer1.{j + 1}",
                     p, st, i)
        for i, spec in enumerate(units):
            _residual_unit(sd, f"{tower}.layer3.{i}", spec,
                           p[f"ResidualUnit_{i}"], st[f"ResidualUnit_{i}"])
    for i, spec in enumerate(FUSION_UNITS):
        _residual_unit(sd, f"layer1.{i}", spec, params[f"ResidualUnit_{i}"],
                       batch_stats[f"ResidualUnit_{i}"])
    _conv_bn(sd, "layer2.0", "layer2.1", params, batch_stats, 0)
    head = params["ConvTranspose_0"]
    sd["layer3.0.weight"] = _t(np.asarray(head["kernel"])[::-1, ::-1],
                               (2, 3, 0, 1))
    sd["layer3.0.bias"] = _b(head["bias"])
    _bn(sd, "layer3.1", params["BatchNorm_1"], batch_stats["BatchNorm_1"])
    return sd


def raft2d_state_dict_from_jax(params: dict) -> dict:
    """JAX ``RAFT2D`` params -> :class:`~sndepth_tpu_torch.models.raft2d.
    RAFT2D` state_dict: ``BasicEncoder_{0,1}`` are ``fnet`` / ``cnet``,
    ``Conv_0`` is ``inp_conv``; in ``Scan_FlowIteration_0``, ``Conv_{0..4}``
    are ``update.{corr1, corr2, flow1, flow2, motion}``,
    ``ConvGRU_0.conv{g}_{i}`` is ``update.gru.conv{g}{i}`` and
    ``{head}_{0,1}`` are ``update.{head}.{0,2}``."""
    sd: dict = {}
    _basic_encoder(sd, "fnet", params["BasicEncoder_0"])
    _basic_encoder(sd, "cnet", params["BasicEncoder_1"])
    _conv(sd, "inp_conv", params["Conv_0"])
    it = params["Scan_FlowIteration_0"]
    for i, key in enumerate(("corr1", "corr2", "flow1", "flow2", "motion")):
        _conv(sd, f"update.{key}", it[f"Conv_{i}"])
    for gate in "zrq":
        for i in (1, 2):
            _conv(sd, f"update.gru.conv{gate}{i}",
                  it["ConvGRU_0"][f"conv{gate}_{i}"])
    for head in ("delta", "mask"):
        _conv(sd, f"update.{head}.0", it[f"{head}_0"])
        _conv(sd, f"update.{head}.2", it[f"{head}_1"])
    return sd


def raft2d_large_state_dict_from_jax(variables: dict) -> dict:
    """JAX ``RAFT2DLarge`` variables (``params`` and the context encoder's
    ``batch_stats``) -> :class:`~sndepth_tpu_torch.models.raft2d.
    RAFT2DLarge` state_dict, in torchvision's ``raft_large`` names: the
    inverse of ``convert_raft2d_large``. A flax ``{block}.conv`` /
    ``{block}.norm`` is ``{block}.0`` / ``{block}.1``, ``layer{l}_{j}`` is
    ``layer{l}.{j}``; in ``update``, ``convgru{k}`` is
    ``update_block.recurrent_block.convgru{k}``, ``flow_head_{1,2}`` are
    ``update_block.flow_head.conv{1,2}`` and ``mask_conv{1,2}`` are
    ``mask_predictor.convrelu.0`` / ``mask_predictor.conv``."""
    params, batch_stats = variables["params"], variables["batch_stats"]
    sd: dict = {}

    def cna(key: str, p: dict, stats: dict | None) -> None:
        _conv(sd, f"{key}.0", p["conv"])
        if "norm" in p:
            _bn(sd, f"{key}.1", p["norm"], stats["norm"])

    for enc in ("feature_encoder", "context_encoder"):
        p, st = params[enc], batch_stats.get(enc, {})
        cna(f"{enc}.convnormrelu", p["convnormrelu"], st.get("convnormrelu"))
        for lvl in (1, 2, 3):
            for j in (0, 1):
                blk, bst = p[f"layer{lvl}_{j}"], st.get(f"layer{lvl}_{j}", {})
                for sub in blk:
                    cna(f"{enc}.layer{lvl}.{j}.{sub}", blk[sub], bst.get(sub))
        _conv(sd, f"{enc}.conv", p["conv"])
    u = params["update"]
    for name, p in u["motion_encoder"].items():
        _conv(sd, f"update_block.motion_encoder.{name}.0", p["conv"])
    for k in (1, 2):
        for gate, p in u[f"convgru{k}"].items():
            _conv(sd, f"update_block.recurrent_block.convgru{k}.{gate}", p)
    _conv(sd, "update_block.flow_head.conv1", u["flow_head_1"]["conv"])
    _conv(sd, "update_block.flow_head.conv2", u["flow_head_2"])
    _conv(sd, "mask_predictor.convrelu.0", u["mask_conv1"]["conv"])
    _conv(sd, "mask_predictor.conv", u["mask_conv2"])
    return sd


# The biases of torchvision's convolutions before a norm, which RAFT2DLarge
# (like the JAX package's) does not have.
_NORMED_CONV_BIAS = re.compile(
    r"^(feature|context)_encoder\.(convnormrelu|layer\d\.\d\."
    r"(convnormrelu[12]|downsample))\.0\.bias$")


def raft2d_large_checkpoint(path: str) -> dict:
    """A torchvision ``raft_large`` ``.pth`` -> a
    :class:`~sndepth_tpu_torch.models.raft2d.RAFT2DLarge` state_dict, as
    ``convert_raft2d_checkpoint`` reads it: the state_dict under ``"model"``
    or ``"state_dict"`` or at the top, ``module.`` prefixes stripped, and the
    biases of the convolutions before a norm dropped (an instance norm
    cancels them exactly; the context encoder's BatchNorm on running
    statistics would not, and the JAX converter drops them all the same)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items()}
    return {k: v for k, v in sd.items() if not _NORMED_CONV_BIAS.match(k)}


def _norm(sd: dict, key: str, p: dict) -> None:
    """A flax GroupNorm or LayerNorm (``scale``, ``bias``)."""
    sd[f"{key}.weight"] = _b(p["scale"])
    sd[f"{key}.bias"] = _b(p["bias"])


def _dense(sd: dict, key: str, p: dict) -> None:
    """A flax Dense (in, out) -> a torch Linear (out, in)."""
    sd[f"{key}.weight"] = _t(p["kernel"], (1, 0))
    if "bias" in p:
        sd[f"{key}.bias"] = _b(p["bias"])


def _resnet_block(sd: dict, t: str, p: dict) -> None:
    _norm(sd, f"{t}.norm1", p["GroupNorm_0"])
    _conv(sd, f"{t}.conv1", p["Conv_0"])
    _norm(sd, f"{t}.norm2", p["GroupNorm_1"])
    _conv(sd, f"{t}.conv2", p["Conv_1"])
    if "Conv_2" in p:
        _conv(sd, f"{t}.nin_shortcut", p["Conv_2"])


def _attn_block(sd: dict, t: str, p: dict) -> None:
    _norm(sd, f"{t}.norm", p["GroupNorm_0"])
    for i, name in enumerate(("q", "k", "v", "proj_out")):
        _conv(sd, f"{t}.{name}", p[f"Conv_{i}"])


def vae_state_dict_from_jax(params: dict, config=None) -> dict:
    """JAX ``AutoencoderKL`` params -> :class:`~sndepth_tpu_torch.models.
    vae.AutoencoderKL` state_dict in the Stable-Diffusion names: the
    inverse of ``convert_vae``. The encoder's ``ResnetBlock_i`` count
    through the levels and then the middle block, its ``Conv_{1..}`` are
    the downsamples and then ``conv_out``; the decoder's count from the
    middle block up through the levels from the last."""
    from sndepth_tpu_torch.models.vae import VAEConfig
    cfg = config or VAEConfig()
    nlv = len(cfg.ch_mult)
    sd: dict = {}
    enc = params["encoder"]
    _conv(sd, "encoder.conv_in", enc["Conv_0"])
    rb = dc = 0
    for i in range(nlv):
        for j in range(cfg.num_res_blocks):
            _resnet_block(sd, f"encoder.down.{i}.block.{j}",
                          enc[f"ResnetBlock_{rb}"])
            rb += 1
        if i != nlv - 1:
            dc += 1
            _conv(sd, f"encoder.down.{i}.downsample.conv", enc[f"Conv_{dc}"])
    _resnet_block(sd, "encoder.mid.block_1", enc[f"ResnetBlock_{rb}"])
    _attn_block(sd, "encoder.mid.attn_1", enc["AttnBlock_0"])
    _resnet_block(sd, "encoder.mid.block_2", enc[f"ResnetBlock_{rb + 1}"])
    _norm(sd, "encoder.norm_out", enc["GroupNorm_0"])
    _conv(sd, "encoder.conv_out", enc[f"Conv_{dc + 1}"])

    dec = params["decoder"]
    _conv(sd, "decoder.conv_in", dec["Conv_0"])
    _resnet_block(sd, "decoder.mid.block_1", dec["ResnetBlock_0"])
    _attn_block(sd, "decoder.mid.attn_1", dec["AttnBlock_0"])
    _resnet_block(sd, "decoder.mid.block_2", dec["ResnetBlock_1"])
    rb, dc = 2, 0
    for i in reversed(range(nlv)):
        for j in range(cfg.num_res_blocks + 1):
            _resnet_block(sd, f"decoder.up.{i}.block.{j}",
                          dec[f"ResnetBlock_{rb}"])
            rb += 1
        if i != 0:
            dc += 1
            _conv(sd, f"decoder.up.{i}.upsample.conv", dec[f"Conv_{dc}"])
    _norm(sd, "decoder.norm_out", dec["GroupNorm_0"])
    _conv(sd, "decoder.conv_out", dec[f"Conv_{dc + 1}"])
    _conv(sd, "quant_conv", params["quant_conv"])
    _conv(sd, "post_quant_conv", params["post_quant_conv"])
    return sd


def _qkv(sd: dict, weight: str, bias: str, p: dict) -> None:
    """flax MultiHeadDotProductAttention (``query``, ``key``, ``value``
    kernels (in, heads, head_dim)) -> one packed (3 dim, dim) weight and its
    bias, under the keys ``weight`` and ``bias``."""
    names = ("query", "key", "value")
    w = [np.asarray(p[n]["kernel"]) for n in names]
    sd[weight] = _t(np.concatenate([x.reshape(x.shape[0], -1) for x in w],
                                   1), (1, 0))
    sd[bias] = _b(np.concatenate([np.asarray(p[n]["bias"]).reshape(-1)
                                  for n in names]))


def _attn_out(sd: dict, key: str, p: dict) -> None:
    """flax MultiHeadDotProductAttention's ``out`` (heads, head_dim, out)
    -> a torch Linear under ``key``."""
    k = np.asarray(p["kernel"])
    sd[f"{key}.weight"] = _t(k.reshape(-1, k.shape[-1]), (1, 0))
    sd[f"{key}.bias"] = _b(p["bias"])


def vit_state_dict_from_jax(params: dict) -> dict:
    """JAX ``ViT`` params -> :class:`~sndepth_tpu_torch.models.vit.ViT`
    state_dict in DINO's names: the inverse of ``convert_dino_vit``. A
    block's attention's ``query`` / ``key`` / ``value`` become the packed
    ``attn.qkv``, its ``out`` ``attn.proj``."""
    sd: dict = {"cls_token": _b(params["cls"]),
                "pos_embed": _b(params["pos_embed"])}
    _conv(sd, "patch_embed.proj", params["Conv_0"])
    _norm(sd, "norm", params["LayerNorm_0"])
    for i in range(len([k for k in params if k.startswith("_Block_")])):
        p, t = params[f"_Block_{i}"], f"blocks.{i}"
        _norm(sd, f"{t}.norm1", p["LayerNorm_0"])
        mha = p["MultiHeadDotProductAttention_0"]
        _qkv(sd, f"{t}.attn.qkv.weight", f"{t}.attn.qkv.bias", mha)
        _attn_out(sd, f"{t}.attn.proj", mha["out"])
        _norm(sd, f"{t}.norm2", p["LayerNorm_1"])
        _dense(sd, f"{t}.mlp.fc1", p["Dense_0"])
        _dense(sd, f"{t}.mlp.fc2", p["Dense_1"])
    return sd


def denoiser_state_dict_from_jax(params: dict) -> dict:
    """JAX ``Denoiser`` params -> :class:`~sndepth_tpu_torch.models.
    denoiser.Denoiser` state_dict: ``TimeStepEmbedding_0.Dense_{0,1}`` are
    ``time_embed.linear.{0,2}``, ``Dense_0`` is ``_first``, the encoder's
    layers ``_trunk.layers.{i}`` (attention packed into
    ``self_attn.in_proj_weight`` / ``in_proj_bias`` and ``out_proj``,
    ``LayerNorm_{0,1}`` ``norm{1,2}``, ``Dense_{0,1}`` ``linear{1,2}``), and
    ``LayerNorm_0``, ``Dense_1``, ``Dense_2`` the head ``_last.{0,1,3}``."""
    sd: dict = {}
    te = params["TimeStepEmbedding_0"]
    _dense(sd, "time_embed.linear.0", te["Dense_0"])
    _dense(sd, "time_embed.linear.2", te["Dense_1"])
    _dense(sd, "_first", params["Dense_0"])
    enc = params["TransformerEncoder_0"]
    for i in range(len(enc)):
        p, t = enc[f"TransformerEncoderLayer_{i}"], f"_trunk.layers.{i}"
        _norm(sd, f"{t}.norm1", p["LayerNorm_0"])
        mha = p["MultiHeadDotProductAttention_0"]
        _qkv(sd, f"{t}.self_attn.in_proj_weight",
             f"{t}.self_attn.in_proj_bias", mha)
        _attn_out(sd, f"{t}.self_attn.out_proj", mha["out"])
        _norm(sd, f"{t}.norm2", p["LayerNorm_1"])
        _dense(sd, f"{t}.linear1", p["Dense_0"])
        _dense(sd, f"{t}.linear2", p["Dense_1"])
    _norm(sd, "_last.0", params["LayerNorm_0"])
    _dense(sd, "_last.1", params["Dense_1"])
    _dense(sd, "_last.3", params["Dense_2"])
    return sd


# ---------------------------------------------------------------------------
# UniAD track (the inverse of convert_uniad)
# ---------------------------------------------------------------------------

UNIAD_BN_EPS = 1e-5


def _mha(sd: dict, key: str, p: dict) -> None:
    """flax MultiHeadDotProductAttention -> the ``in_proj_weight``,
    ``in_proj_bias`` and ``out_proj`` of
    :class:`~sndepth_tpu_torch.ops.layers.MultiheadAttention`."""
    _qkv(sd, f"{key}.in_proj_weight", f"{key}.in_proj_bias", p)
    _attn_out(sd, f"{key}.out_proj", p["out"])


def _uniad_norm(sd: dict, key: str, p: dict, affine: bool) -> None:
    """A ``_ChannelAffine`` (scale, bias) as a frozen BatchNorm whose
    ``weight / sqrt(running_var + eps)`` is the scale exactly
    (``running_var = 1 - eps``, ``running_mean = 0``), or a GroupNorm."""
    _norm(sd, key, p)
    if affine:
        c = np.asarray(p["scale"]).shape[0]
        sd[f"{key}.running_mean"] = torch.zeros(c)
        sd[f"{key}.running_var"] = torch.full((c,), 1.0 - UNIAD_BN_EPS)


def _uniad_backbone(sd: dict, p: dict, blocks, stage_with_dcn) -> None:
    affine = "_ChannelAffine_0" in p
    nm = "_ChannelAffine" if affine else "GroupNorm"
    _conv(sd, "img_backbone.conv1", p["Conv_0"])
    _uniad_norm(sd, "img_backbone.bn1", p[f"{nm}_0"], affine)
    n = 0
    for si, nb in enumerate(blocks):
        for bi in range(nb):
            t = f"img_backbone.layer{si + 1}.{bi}"
            blk = p[f"_Bottleneck_{n}"]
            n += 1
            _conv(sd, f"{t}.conv1", blk["Conv_0"])
            if stage_with_dcn[si]:
                dcn = blk["DeformConv2d_0"]
                k = np.asarray(dcn["kernel"])             # (kk, in, out)
                kh = int(round(k.shape[0] ** 0.5))
                sd[f"{t}.conv2.weight"] = _t(
                    k.reshape(kh, kh, *k.shape[1:]), (3, 2, 0, 1))
                _conv(sd, f"{t}.conv2.conv_offset", dcn["conv_offset"])
                ci = 1
            else:
                _conv(sd, f"{t}.conv2", blk["Conv_1"])
                ci = 2
            _conv(sd, f"{t}.conv3", blk[f"Conv_{ci}"])
            names = ["bn1", "bn2", "bn3"]
            if f"Conv_{ci + 1}" in blk:
                _conv(sd, f"{t}.downsample.0", blk[f"Conv_{ci + 1}"])
                names.append("downsample.1")
            for j, name in enumerate(names):
                _uniad_norm(sd, f"{t}.{name}", blk[f"{nm}_{j}"], affine)
    for i in range(3):
        _conv(sd, f"img_neck.lateral_convs.{i}.conv", p[f"Conv_{i + 1}"])
    for i in range(4):
        _conv(sd, f"img_neck.fpn_convs.{i}.conv", p[f"Conv_{i + 4}"])


def _deform_attn(sd: dict, key: str, p: dict) -> None:
    for name in ("sampling_offsets", "attention_weights", "value_proj",
                 "output_proj"):
        if name in p:
            _dense(sd, f"{key}.{name}", p[name])


def _ffn(sd: dict, key: str, p: dict) -> None:
    _dense(sd, f"{key}.layers.0.0", p["Dense_0"])
    _dense(sd, f"{key}.layers.1", p["Dense_1"])


def _uniad_head(sd: dict, p: dict) -> None:
    h = "pts_bbox_head"
    t = f"{h}.transformer"
    sd[f"{h}.bev_embedding.weight"] = _b(p["bev_embedding"])
    sd[f"{t}.level_embeds"] = _b(p["level_embeds"])
    sd[f"{t}.cams_embeds"] = _b(p["cams_embeds"])
    _dense(sd, f"{t}.can_bus_mlp.0", p["can_bus_mlp1"])
    _dense(sd, f"{t}.can_bus_mlp.2", p["can_bus_mlp2"])
    _norm(sd, f"{t}.can_bus_mlp.norm", p["can_bus_norm"])
    enc, dec = p["encoder"], p["decoder"]
    n_enc = sum(k.startswith("TemporalSelfAttention_") for k in enc)
    for i in range(n_enc):
        q = f"{t}.encoder.layers.{i}"
        _deform_attn(sd, f"{q}.attentions.0", enc[f"TemporalSelfAttention_{i}"])
        sca = enc[f"SpatialCrossAttention_{i}"]
        _deform_attn(sd, f"{q}.attentions.1.deformable_attention",
                     sca["deformable_attention"])
        _dense(sd, f"{q}.attentions.1.output_proj", sca["output_proj"])
        _ffn(sd, f"{q}.ffns.0", enc[f"FFN_{i}"])
        for j in range(3):
            _norm(sd, f"{q}.norms.{j}", enc[f"LayerNorm_{3 * i + j}"])
    n_dec = sum(k.startswith("CustomMSDeformableAttention_") for k in dec)
    for i in range(n_dec):
        q = f"{t}.decoder.layers.{i}"
        _mha(sd, f"{q}.attentions.0.attn",
             dec[f"MultiHeadDotProductAttention_{i}"])
        _deform_attn(sd, f"{q}.attentions.1",
                     dec[f"CustomMSDeformableAttention_{i}"])
        _ffn(sd, f"{q}.ffns.0", dec[f"FFN_{i}"])
        for j in range(3):
            _norm(sd, f"{q}.norms.{j}", dec[f"LayerNorm_{3 * i + j}"])
        for flax_name, torch_name, ln in (
                ("cls_branches", "cls_branches", True),
                ("reg_branches", "reg_branches", False),
                ("past_traj_branches", "past_traj_reg_branches", False)):
            br = p[f"{flax_name}_{i}"]
            idx = (0, 3, 6) if ln else (0, 2, 4)
            for d, ti in enumerate(idx):
                _dense(sd, f"{h}.{torch_name}.{i}.{ti}", br[f"Dense_{d}"])
            if ln:
                _norm(sd, f"{h}.{torch_name}.{i}.1", br["LayerNorm_0"])
                _norm(sd, f"{h}.{torch_name}.{i}.4", br["LayerNorm_1"])


def uniad_state_dict_from_jax(params: dict, blocks=(3, 4, 23, 3),
                              stage_with_dcn=(False, False, True, True)
                              ) -> dict:
    """JAX ``UniADTrack`` params -> :class:`~sndepth_tpu_torch.models.
    uniad_track.UniADTrack` state_dict in the reference's names: the
    inverse of ``convert_uniad``, for either backbone norm (the frozen-BN
    channel affine, or GroupNorm). The layer counts come from the tree;
    ``blocks`` and ``stage_with_dcn`` give the backbone's stage plan."""
    sd: dict = {}
    _uniad_backbone(sd, params["backbone"], blocks, stage_with_dcn)
    _uniad_head(sd, params["head"])
    sd["query_embedding.weight"] = _b(params["query_embedding"])
    _dense(sd, "reference_points", params["reference_points"])
    mb = params["memory_bank"]
    _dense(sd, "memory_bank.save_proj", mb["save_proj"])
    _mha(sd, "memory_bank.temporal_attn", mb["temporal_attn"])
    for name in ("temporal_fc1", "temporal_fc2"):
        _dense(sd, f"memory_bank.{name}", mb[name])
    for name in ("temporal_norm1", "temporal_norm2"):
        _norm(sd, f"memory_bank.{name}", mb[name])
    qim = params["qim"]
    q = "query_interact"
    _mha(sd, f"{q}.self_attn", qim["MultiHeadDotProductAttention_0"])
    for flax_name, torch_name in (("Dense_0", "linear1"),
                                  ("Dense_1", "linear2"),
                                  ("pos_ffn1", "linear_pos1"),
                                  ("pos_ffn2", "linear_pos2"),
                                  ("feat_ffn1", "linear_feat1"),
                                  ("feat_ffn2", "linear_feat2")):
        _dense(sd, f"{q}.{torch_name}", qim[flax_name])
    for flax_name, torch_name in (("LayerNorm_0", "norm1"),
                                  ("LayerNorm_1", "norm2"),
                                  ("pos_norm", "norm_pos"),
                                  ("feat_norm", "norm_feat")):
        _norm(sd, f"{q}.{torch_name}", qim[flax_name])
    return sd
