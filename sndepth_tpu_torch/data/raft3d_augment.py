"""RAFT3D training augmentors (host-side numpy, NHWC).

The port's own copy of ``sndepth_tpu/data/raft3d_augment.py``: the same
outputs from the same seeds. Parity with the reference's
`utils/data_readers/augmentation.py`:
* :class:`RGBDAugmentor` — joint color jitter over both frames,
  log2-uniform scale in [min_scale, 0.5] (applied with prob 0.8), random
  crop, intrinsics updated accordingly;
* :class:`SparseAugmentor` — same, but flow maps with sparse validity are
  resized by scattering valid samples to rounded target coordinates
  (`augmentation.py:68-96`), and the crop window may over-range +-50/+20 px
  before clamping (`:143-147`).

Color jitter is a numpy reimplementation of torchvision's
brightness/contrast/saturation/hue jitter (order randomized per call).
"""

from __future__ import annotations

import math

import numpy as np


def _rgb_to_gray(img):
    return (img @ np.array([0.299, 0.587, 0.114], img.dtype))[..., None]


def color_jitter(rng: np.random.RandomState, img01: np.ndarray,
                 brightness=0.25, contrast=0.25, saturation=0.25,
                 hue=0.4 / 3.14) -> np.ndarray:
    """Apply torchvision-style jitter to a [0,1] RGB image."""
    out = img01.astype(np.float32)
    ops = rng.permutation(4)
    for op in ops:
        if op == 0 and brightness > 0:
            f = rng.uniform(1 - brightness, 1 + brightness)
            out = out * f
        elif op == 1 and contrast > 0:
            f = rng.uniform(1 - contrast, 1 + contrast)
            mean = _rgb_to_gray(out).mean()
            out = (out - mean) * f + mean
        elif op == 2 and saturation > 0:
            f = rng.uniform(1 - saturation, 1 + saturation)
            gray = _rgb_to_gray(out)
            out = (out - gray) * f + gray
        elif op == 3 and hue > 0:
            # cheap hue rotation via channel mixing in YIQ space
            theta = rng.uniform(-hue, hue) * 2 * np.pi
            cos_t, sin_t = np.cos(theta), np.sin(theta)
            t_yiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.322],
                              [0.211, -0.523, 0.312]], np.float32)
            rot = np.array([[1, 0, 0],
                            [0, cos_t, -sin_t],
                            [0, sin_t, cos_t]], np.float32)
            t_rgb = np.linalg.inv(t_yiq)
            out = out @ (t_rgb @ rot @ t_yiq).T
    return np.clip(out, 0.0, 1.0)


def _resize_bilinear(img, ht, wd):
    import cv2
    return cv2.resize(img, (wd, ht), interpolation=cv2.INTER_LINEAR)


def _resize_nearest(img, ht, wd):
    import cv2
    return cv2.resize(img, (wd, ht), interpolation=cv2.INTER_NEAREST)


def resize_sparse_image(data: np.ndarray, valid: np.ndarray, ht1: int,
                        wd1: int) -> tuple[np.ndarray, np.ndarray]:
    """Scatter valid samples to rounded resized coordinates
    (`augmentation.py:68-96`)."""
    ht, wd = data.shape[:2]
    vmask = valid > 0.5
    ys, xs = np.nonzero(vmask)
    xx = np.round(xs * wd1 / float(wd)).astype(np.int32)
    yy = np.round(ys * ht1 / float(ht)).astype(np.int32)
    keep = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
    out = np.zeros((ht1, wd1, data.shape[-1]), np.float32)
    out_valid = np.zeros((ht1, wd1), np.float32)
    out[yy[keep], xx[keep]] = data[ys[keep], xs[keep]]
    out_valid[yy[keep], xx[keep]] = 1.0
    return out, out_valid


class RGBDAugmentor:
    def __init__(self, crop_size, seed: int = 0):
        self.crop_size = tuple(crop_size)
        self.rng = np.random.RandomState(seed)

    def __call__(self, image1, image2, depth1, depth2, flow, intrinsics):
        rng = self.rng
        stacked = np.concatenate([image1, image2], axis=1) / 255.0
        stacked = color_jitter(rng, stacked) * 255.0
        image1, image2 = np.split(stacked, 2, axis=1)

        ht, wd = image1.shape[:2]
        ch, cw = self.crop_size
        min_scale = np.log2(max((ch + 1) / ht, (cw + 1) / wd))
        scale = 2.0 ** rng.uniform(min_scale, 0.5)
        intrinsics = np.asarray(intrinsics, np.float32).copy()
        if rng.rand() < 0.8:
            ht1, wd1 = int(math.ceil(ht * scale)), int(math.ceil(wd * scale))
            sx, sy = wd1 / wd, ht1 / ht
            intrinsics *= np.array([sx, sy, sx, sy], np.float32)
            image1 = _resize_bilinear(image1, ht1, wd1)
            image2 = _resize_bilinear(image2, ht1, wd1)
            depth1 = _resize_nearest(depth1, ht1, wd1)
            depth2 = _resize_nearest(depth2, ht1, wd1)
            flow = _resize_bilinear(flow, ht1, wd1) * np.array(
                [sx, sy, 1.0], np.float32)
        else:
            ht1, wd1 = ht, wd

        y0 = rng.randint(0, max(ht1 - ch, 0) + 1)
        x0 = rng.randint(0, max(wd1 - cw, 0) + 1)
        sl = np.s_[y0:y0 + ch, x0:x0 + cw]
        intrinsics -= np.array([0.0, 0.0, x0, y0], np.float32)
        return (image1[sl], image2[sl], depth1[sl], depth2[sl], flow[sl],
                intrinsics)


class SparseAugmentor:
    def __init__(self, crop_size, seed: int = 0):
        self.crop_size = tuple(crop_size)
        self.rng = np.random.RandomState(seed)

    def __call__(self, image1, image2, depth1, depth2, flow, valid,
                 intrinsics):
        rng = self.rng
        stacked = np.concatenate([image1, image2], axis=1) / 255.0
        stacked = color_jitter(rng, stacked) * 255.0
        image1, image2 = np.split(stacked, 2, axis=1)

        ht, wd = image1.shape[:2]
        ch, cw = self.crop_size
        min_scale = np.log2(max((ch + 1) / ht, (cw + 1) / wd))
        scale = 2.0 ** rng.uniform(min_scale, 0.5)
        intrinsics = np.asarray(intrinsics, np.float32).copy()
        if rng.rand() < 0.8:
            ht1, wd1 = int(math.ceil(ht * scale)), int(math.ceil(wd * scale))
            sx, sy = wd1 / wd, ht1 / ht
            intrinsics *= np.array([sx, sy, sx, sy], np.float32)
            image1 = _resize_bilinear(image1, ht1, wd1)
            image2 = _resize_bilinear(image2, ht1, wd1)
            depth1 = _resize_nearest(depth1, ht1, wd1)
            depth2 = _resize_nearest(depth2, ht1, wd1)
            flow, valid = resize_sparse_image(flow, valid, ht1, wd1)
            flow = flow * np.array([sx, sy, 1.0], np.float32)
        else:
            ht1, wd1 = ht, wd

        # over-ranged crop window, then clamp (`augmentation.py:143-147`)
        y0 = rng.randint(0, max(ht1 - ch + 20, 1))
        x0 = rng.randint(-50, max(wd1 - cw + 50, -49))
        y0 = int(np.clip(y0, 0, ht1 - ch))
        x0 = int(np.clip(x0, 0, wd1 - cw))
        sl = np.s_[y0:y0 + ch, x0:x0 + cw]
        intrinsics -= np.array([0.0, 0.0, x0, y0], np.float32)
        return (image1[sl], image2[sl], depth1[sl], depth2[sl], flow[sl],
                valid[sl], intrinsics)
