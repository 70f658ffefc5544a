"""Carry JAX parameters of ``sndepth_tpu`` into the port's state_dicts.

The inverse of ``sndepth_tpu/utils/convert_weights.py``
(:func:`convert_dispnet`, :func:`convert_flownet`,
:func:`convert_posenet`, :func:`convert_raft3d`). Parameters come in as
nested dicts of numpy arrays. Conv kernels (kh, kw, in, out) become
(out, in, kh, kw); ConvTranspose kernels become (in, out, kh, kw) by a
plain transpose, because the JAX ``TorchConvTranspose2x`` flips its taps at
apply time. Flax ``_UpConv_i`` / ``_IConv_i`` are torch level ``7 - i``;
heads ``Conv_0..3`` are ``predict_disp4..1`` (DispNetS) or ``flow4..1``
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
