"""Carry JAX parameters of ``sndepth_tpu`` into the port's state_dicts.

The inverse of ``sndepth_tpu/utils/convert_weights.py``
(:func:`convert_dispnet`, :func:`convert_flownet`,
:func:`convert_posenet`). Parameters come in as nested dicts of numpy
arrays. Conv kernels (kh, kw, in, out) become
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
