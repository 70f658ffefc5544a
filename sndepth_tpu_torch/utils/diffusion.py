"""Diffusion schedules and DDIM helpers.

Counterpart of ``sndepth_tpu/utils/diffusion.py`` (reference
`utils/util_diffusion.py`): the beta schedules (linear, cosine, sqrt-linear,
sqrt) in float64, DDIM timestep subsampling and its sigmas, in numpy; and
:func:`extract_into_tensor`, which gathers per-timestep coefficients for a
batch of timesteps on their device.
"""

from __future__ import annotations

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int,
                       linear_start: float = 1e-4,
                       linear_end: float = 2e-2,
                       cosine_s: float = 8e-3) -> np.ndarray:
    if schedule == "linear":
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5,
                            n_timestep, dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = (np.arange(n_timestep + 1, dtype=np.float64) /
                     n_timestep + cosine_s)
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep,
                            dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep,
                            dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"unknown beta schedule '{schedule}'")
    return betas.astype(np.float64)


def make_ddim_timesteps(ddim_discr_method: str, num_ddim_timesteps: int,
                        num_ddpm_timesteps: int) -> np.ndarray:
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif ddim_discr_method == "quad":
        ddim_timesteps = ((np.linspace(
            0, np.sqrt(num_ddpm_timesteps * 0.8),
            num_ddim_timesteps)) ** 2).astype(int)
    else:
        raise NotImplementedError(ddim_discr_method)
    return ddim_timesteps + 1


def make_ddim_sampling_parameters(alphacums: np.ndarray,
                                  ddim_timesteps: np.ndarray, eta: float):
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray(
        [alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) *
                           (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def extract_into_tensor(a, t: torch.Tensor, x_shape) -> torch.Tensor:
    """``a[t]`` for timesteps ``t`` (B,), shaped (B, 1, ..., 1) to
    broadcast against ``x_shape``; a numpy ``a`` comes to ``t``'s device
    in float32."""
    a = torch.as_tensor(a, dtype=torch.float32 if isinstance(a, np.ndarray)
                        else None, device=t.device)
    out = a[t]
    return out.reshape(out.shape[0], *((1,) * (len(x_shape) - 1)))
