"""AutoencoderKL: the Stable-Diffusion KL autoencoder over RGBD (NCHW).

Counterpart of ``sndepth_tpu/models/vae.py``, with the reference's
Stable-Diffusion state_dict names (``encoder.down.{i}.block.{j}.conv1``,
``encoder.mid.attn_1.q``, ``decoder.up.{i}.upsample.conv``, ``quant_conv``
...), so that ``convert_vae`` maps a state_dict of the port to the JAX
package's parameters: a 4-channel (RGB + depth) input, a 4-channel latent at
1/8 resolution, channel multipliers (1, 2, 4, 4), two residual blocks a
level and self-attention in the middle (:func:`get_autoencoder`), and the
diagonal Gaussian posterior (:class:`DiagonalGaussian`, :func:`normal_kl`).

Also the DDPM variants the reference carries: :class:`DDPMUNet`,
:class:`SimpleDecoder`, :class:`UpsampleDecoder` and
:class:`LatentRescaler`.

As in JAX: GroupNorm of 32 groups at epsilon 1e-6; a (0, 1) pad before
each stride-2 convolution; nearest 2x upsampling. Everything runs in
float32, as every caller of the JAX modules runs them: their ``dtype``
field has no counterpart here. The posterior's draw takes its noise from
the caller (``DiagonalGaussian.sample``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 4
    out_channels: int = 4
    base_ch: int = 128
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4
    double_z: bool = True


def _gn(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=1e-6)


class ResnetBlock(nn.Module):
    """DDPM residual block; with ``temb_ch`` a timestep embedding is added
    between the two convolutions."""

    def __init__(self, c_in: int, c_out: int, temb_ch: int = 0):
        super().__init__()
        self.norm1 = _gn(c_in)
        self.conv1 = nn.Conv2d(c_in, c_out, 3, 1, 1)
        if temb_ch:
            self.temb_proj = nn.Linear(temb_ch, c_out)
        self.norm2 = _gn(c_out)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, 1, 1)
        if c_in != c_out:
            self.nin_shortcut = nn.Conv2d(c_in, c_out, 1)

    def forward(self, x: torch.Tensor,
                temb: torch.Tensor | None = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H W positions, with a residual."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = _gn(c)
        for name in ("q", "k", "v", "proj_out"):
            setattr(self, name, nn.Conv2d(c, c, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x)
        q, k, v = (getattr(self, n)(y).flatten(2) for n in "qkv")  # b,c,hw
        logits = torch.matmul(q.transpose(1, 2), k)
        attn = torch.softmax(logits * c ** -0.5, -1)
        out = torch.matmul(v, attn.transpose(1, 2)).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """A (0, 1) pad and a stride-2 3x3 convolution."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, 2, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest 2x upsampling and a 3x3 convolution."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Mid(nn.Module):
    def __init__(self, c: int, temb_ch: int):
        super().__init__()
        self.block_1 = ResnetBlock(c, c, temb_ch)
        self.attn_1 = AttnBlock(c)
        self.block_2 = ResnetBlock(c, c, temb_ch)

    def forward(self, h, temb=None):
        return self.block_2(self.attn_1(self.block_1(h, temb)), temb)


class _Level(nn.Module):
    """One resolution: ``block`` (and ``attn``) lists and, between levels,
    a ``downsample`` or ``upsample``."""

    def __init__(self, blocks: list, attn: list | None = None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if attn:
            self.attn = nn.ModuleList(attn)


class VAEEncoder(nn.Module):
    """(B, in_channels, H, W) -> moments (B, 2 z_channels, H/2^(L-1),
    W/2^(L-1)), float32."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        cfg = config
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.base_ch, 3, 1, 1)
        self.down = nn.ModuleList()
        ch = cfg.base_ch
        for i, mult in enumerate(cfg.ch_mult):
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(ch, cfg.base_ch * mult))
                ch = cfg.base_ch * mult
            level = _Level(blocks)
            if i != len(cfg.ch_mult) - 1:
                level.downsample = Downsample(ch)
            self.down.append(level)
        self.mid = _Mid(ch, 0)
        self.norm_out = _gn(ch)
        self.conv_out = nn.Conv2d(
            ch, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels, 3,
            1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = F.silu(self.norm_out(self.mid(h)))
        return self.conv_out(h)


class VAEDecoder(nn.Module):
    """latent (B, z_channels, h, w) -> (B, out_channels, h 2^(L-1),
    w 2^(L-1)), float32."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        cfg = config
        ch = cfg.base_ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, ch, 3, 1, 1)
        self.mid = _Mid(ch, 0)
        levels = {}
        for i, mult in reversed(list(enumerate(cfg.ch_mult))):
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(ch, cfg.base_ch * mult))
                ch = cfg.base_ch * mult
            levels[i] = _Level(blocks)
            if i != 0:
                levels[i].upsample = Upsample(ch)
        # Indexed by level, applied from the last.
        self.up = nn.ModuleList(levels[i] for i in range(len(cfg.ch_mult)))
        self.norm_out = _gn(ch)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, 1, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class DiagonalGaussian:
    """The posterior over latents from moments (B, 2 C, h, w) = [mean |
    logvar] along the channels; the log-variance clipped to [-30, 20]."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, noise: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """mean + std * noise; ``noise`` (the mean's shape) is drawn
        standard normal from ``generator`` when not given."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                dtype=self.mean.dtype,
                                device=self.mean.device)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: "DiagonalGaussian | None" = None) -> torch.Tensor:
        if other is None:
            return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0
                                   - self.logvar, dim=(1, 2, 3))
        return 0.5 * torch.sum(
            (self.mean - other.mean) ** 2 / other.var
            + self.var / other.var - 1.0
            + other.logvar - self.logvar, dim=(1, 2, 3))

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.sum(
            math.log(2.0 * math.pi) + self.logvar
            + (sample - self.mean) ** 2 / self.var, dim=(1, 2, 3))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL divergence between two Gaussians, elementwise."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


class AutoencoderKL(nn.Module):
    """``encode(x)`` -> :class:`DiagonalGaussian`; ``decode(z)`` -> the
    reconstruction; ``forward(x, noise)`` -> (reconstruction, posterior),
    decoding the posterior's draw with ``noise`` when given, else its
    mean."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = VAEEncoder(config)
        self.decoder = VAEDecoder(config)
        self.quant_conv = nn.Conv2d(2 * config.z_channels,
                                    2 * config.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(config.embed_dim,
                                         config.z_channels, 1)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian(self.quant_conv(self.encoder(x)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None):
        posterior = self.encode(x)
        z = posterior.mode() if noise is None else posterior.sample(noise)
        return self.decode(z), posterior


def get_autoencoder() -> AutoencoderKL:
    """The reference's RGBD autoencoder (`AutoencoderKL.py:151-177`)."""
    return AutoencoderKL(VAEConfig())


# ----------------------------------------------------------------------
# The DDPM variants
# ----------------------------------------------------------------------

class _TimeEmbedding(nn.Module):
    def __init__(self, ch: int, temb_ch: int):
        super().__init__()
        self.dense = nn.ModuleList([nn.Linear(ch, temb_ch),
                                    nn.Linear(temb_ch, temb_ch)])

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.dense[1](F.silu(self.dense[0](emb)))


class DDPMUNet(nn.Module):
    """The timestep-conditioned UNet (the reference's ``Model``): skips
    from every down block, an optional sinusoid time embedding and an
    optional context concatenated on the channels. forward(x, t, context)
    -> (B, out_ch, H, W), float32; ``in_channels`` counts the context's."""

    def __init__(self, in_channels: int = 3, ch: int = 64, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (),
                 resolution: int = 64, use_timestep: bool = True):
        super().__init__()
        self.ch = ch
        self.use_timestep = use_timestep
        temb_ch = 4 * ch if use_timestep else 0
        if use_timestep:
            self.temb = _TimeEmbedding(ch, temb_ch)
        self.conv_in = nn.Conv2d(in_channels, ch, 3, 1, 1)
        skips, c, res = [ch], ch, resolution
        self.down = nn.ModuleList()
        for i, mult in enumerate(ch_mult):
            blocks, attn = [], []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(c, ch * mult, temb_ch))
                c = ch * mult
                if res in attn_resolutions:
                    attn.append(AttnBlock(c))
                skips.append(c)
            level = _Level(blocks, attn)
            if i != len(ch_mult) - 1:
                level.downsample = Downsample(c)
                skips.append(c)
                res //= 2
            self.down.append(level)
        self.mid = _Mid(c, temb_ch)
        levels = {}
        for i, mult in reversed(list(enumerate(ch_mult))):
            blocks, attn = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(c + skips.pop(), ch * mult,
                                          temb_ch))
                c = ch * mult
                if res in attn_resolutions:
                    attn.append(AttnBlock(c))
            levels[i] = _Level(blocks, attn)
            if i != 0:
                levels[i].upsample = Upsample(c)
                res *= 2
        self.up = nn.ModuleList(levels[i] for i in range(len(ch_mult)))
        self.norm_out = _gn(c)
        self.conv_out = nn.Conv2d(c, out_ch, 3, 1, 1)

    def forward(self, x, t=None, context=None):
        from sndepth_tpu_torch.models.denoiser import timestep_embedding
        if context is not None:
            x = torch.cat([x, context], 1)
        temb = (self.temb(timestep_embedding(t, self.ch))
                if self.use_timestep else None)
        hs = [self.conv_in(x)]
        for level in self.down:
            for j, block in enumerate(level.block):
                h = block(hs[-1], temb)
                if hasattr(level, "attn"):
                    h = level.attn[j](h)
                hs.append(h)
            if hasattr(level, "downsample"):
                hs.append(level.downsample(hs[-1]))
        h = self.mid(hs[-1], temb)
        for level in reversed(self.up):
            for j, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], 1), temb)
                if hasattr(level, "attn"):
                    h = level.attn[j](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class SimpleDecoder(nn.Module):
    """1x1, three residual blocks (2x, 4x, 2x wide), 1x1, a 2x upsampling
    convolution, then the norm and the output convolution."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        c = in_channels
        self.model = nn.ModuleList([
            nn.Conv2d(c, c, 1), ResnetBlock(c, 2 * c),
            ResnetBlock(2 * c, 4 * c), ResnetBlock(4 * c, 2 * c),
            nn.Conv2d(2 * c, c, 1), Upsample(c)])
        self.norm_out = _gn(c)
        self.conv_out = nn.Conv2d(c, out_channels, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.model:
            x = layer(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class UpsampleDecoder(nn.Module):
    """Residual blocks with nearest 2x upsampling between the levels."""

    def __init__(self, in_channels: int, out_channels: int, ch: int,
                 num_res_blocks: int = 2, ch_mult: Sequence[int] = (2, 2)):
        super().__init__()
        c = in_channels
        self.res_blocks = nn.ModuleList()
        self.upsample_blocks = nn.ModuleList()
        for i, mult in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(c, ch * mult))
                c = ch * mult
            self.res_blocks.append(nn.ModuleList(blocks))
            if i != len(ch_mult) - 1:
                self.upsample_blocks.append(Upsample(c))
        self.norm_out = _gn(c)
        self.conv_out = nn.Conv2d(c, out_channels, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, blocks in enumerate(self.res_blocks):
            for block in blocks:
                h = block(h)
            if i < len(self.upsample_blocks):
                h = self.upsample_blocks[i](h)
        return self.conv_out(F.silu(self.norm_out(h)))


class LatentRescaler(nn.Module):
    """Residual blocks, a nearest resize by ``factor``, attention, residual
    blocks and a 1x1 output convolution."""

    def __init__(self, factor: float, in_channels: int, mid_channels: int,
                 out_channels: int, depth: int = 2):
        super().__init__()
        self.factor = factor
        self.conv_in = nn.Conv2d(in_channels, mid_channels, 3, 1, 1)
        self.res_block1 = nn.ModuleList(
            ResnetBlock(mid_channels, mid_channels)
            for _ in range(depth))
        self.attn = AttnBlock(mid_channels)
        self.res_block2 = nn.ModuleList(
            ResnetBlock(mid_channels, mid_channels)
            for _ in range(depth))
        self.conv_out = nn.Conv2d(mid_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for block in self.res_block1:
            h = block(h)
        size = (int(round(h.shape[2] * self.factor)),
                int(round(h.shape[3] * self.factor)))
        # Half-pixel nearest, as jax.image.resize "nearest".
        h = self.attn(F.interpolate(h, size=size, mode="nearest-exact"))
        for block in self.res_block2:
            h = block(h)
        return self.conv_out(h)
