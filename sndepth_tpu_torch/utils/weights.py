"""Carry JAX parameters of ``sndepth_tpu`` into the port's state_dicts.

The inverse of ``sndepth_tpu/utils/convert_weights.py``
(:func:`convert_dispnet`, :func:`convert_flownet`,
:func:`convert_posenet`, :func:`convert_raft3d`,
:func:`convert_efficientnet`, :func:`convert_normal_decoder`,
:func:`convert_motionfusion`). Parameters come in as nested dicts of numpy
arrays. Conv kernels (kh, kw, in, out) become (out, in, kh, kw);
ConvTranspose kernels become (in, out, kh, kw) by a plain transpose, because
the JAX ``TorchConvTranspose2x`` flips its taps at apply time, except
MotionFusionNet's head, whose taps flax stores flipped. Flax ``_UpConv_i`` /
``_IConv_i`` are torch level ``7 - i``; heads ``Conv_0..3`` are ``predict_disp4..1`` (DispNetS) or ``flow4..1``
(FlowNet).
"""

from __future__ import annotations

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
    fnet = params["BasicEncoder_0"]
    _conv(sd, "fnet.conv1", fnet["Conv_0"])
    _conv(sd, "fnet.conv2", fnet["Conv_1"])
    for bi in range(6):
        blk = fnet[f"_ResBlock_{bi}"]
        t = f"fnet.layer{bi // 2 + 1}.{bi % 2}"
        _conv(sd, f"{t}.conv1", blk["Conv_0"])
        _conv(sd, f"{t}.conv2", blk["Conv_1"])
        if "Conv_2" in blk:
            _conv(sd, f"{t}.downsample.0", blk["Conv_2"])

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
