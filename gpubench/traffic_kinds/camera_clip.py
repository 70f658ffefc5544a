"""A clip of distinct six-camera frames of the nuScenes surround rig (the
rig of ``sndepth_tpu_torch/utils/uniad.surround_lidar2img``, copied here),
timestamps ``dt_s`` apart and a seeded ego shift and rotation for each
frame; the frames lie on the device.

Parameters: ``frames``, ``dt_s``, ``ego_shift_std`` (grid fractions),
``ego_rotation_std_deg``, and from the configuration ``cams``, ``height``
and ``width``.
"""

from __future__ import annotations

import math

import torch

from gpubench.generator import seeded

# The nuScenes surround rig: six cameras at these yaws (degrees,
# counter-clockwise from the lidar's forward x axis), focal length 1266
# pixels at 1600-wide images, 1.5 m above the lidar's origin.
SURROUND_YAWS = (0.0, -55.0, 55.0, -110.0, 110.0, 180.0)
SURROUND_FOCAL_PER_WIDTH = 1266.0 / 1600.0


def surround_lidar2img(h: int, w: int, height: float = 1.5) -> torch.Tensor:
    """(1, cams, 4, 4) ``lidar2img`` of pinhole cameras at the lidar's
    origin raised by ``height``, looking out horizontally at the rig's
    yaws, focal length ``SURROUND_FOCAL_PER_WIDTH * w`` at the image
    centre. Lidar axes: x forward, y left, z up; camera axes: x right, y
    down, z forward."""
    f = SURROUND_FOCAL_PER_WIDTH * w
    k = torch.tensor([[f, 0.0, w / 2.0, 0.0], [0.0, f, h / 2.0, 0.0],
                      [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]],
                     dtype=torch.float64)
    mats = []
    for yaw in SURROUND_YAWS:
        a = math.radians(yaw)
        rot = torch.tensor([[math.sin(a), -math.cos(a), 0.0],
                            [0.0, 0.0, -1.0],
                            [math.cos(a), math.sin(a), 0.0]],
                           dtype=torch.float64)
        ext = torch.eye(4, dtype=torch.float64)
        ext[:3, :3] = rot
        ext[:3, 3] = -rot @ torch.tensor([0.0, 0.0, height],
                                         dtype=torch.float64)
        mats.append(k @ ext)
    return torch.stack(mats)[None].float()


def generate(p: dict, seed: int, device) -> dict:
    """``p["frames"]`` distinct frames of ``p["cams"]`` cameras at
    ``p["height"]`` x ``p["width"]`` on the device: {"images": (F, cams, 1,
    3, H, W) float32 in [0, 1), "lidar2img": (1, cams, 4, 4), "dt_s",
    "ego_shift": (F, 1, 2) grid fractions, "ego_rotation_deg": (F, 1)}."""
    cams = p["cams"]
    if cams != len(SURROUND_YAWS):
        raise ValueError(f"the rig has {len(SURROUND_YAWS)} cameras")
    gen = seeded(seed, "camera_clip", device)
    f, h, w = p["frames"], p["height"], p["width"]
    images = torch.rand(f, cams, 1, 3, h, w, generator=gen, device=device)
    shift = torch.randn(f, 1, 2, generator=gen, device=device) * p[
        "ego_shift_std"]
    rot = torch.randn(f, 1, generator=gen, device=device) * p[
        "ego_rotation_std_deg"]
    return {"images": images, "lidar2img": surround_lidar2img(h, w).to(
        device), "dt_s": float(p["dt_s"]), "ego_shift": shift,
        "ego_rotation_deg": rot}
