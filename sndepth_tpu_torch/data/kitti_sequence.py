"""KITTI 3-frame sequence dataset (host-side input pipeline).

The port's own copy of ``sndepth_tpu/data/kitti_sequence.py``: the same
samples from the same files and seeds, decoded through ``cv2`` or ``PIL``
(the JAX package's native codec is not ported). Reads the same on-disk
format as the reference `SequenceFolder`
(reference `models/sequence_folders.py:210-283`):

* ``{root}/{split}.txt`` lines of ``"<scene_dir> <frame_id>"``;
* ``{root}/<scene_dir>/<frame_id>.jpg`` — the sequence frames concatenated
  horizontally as ``[t-1 | t | t+1]`` (target is the middle frame, sources
  the outer two, `sequence_folders.py:12-28`);
* ``{root}/<scene_dir>/<frame_id>_cam.txt`` — 9 comma-separated intrinsics.

Train-time augmentation matches `sequence_folders.py:42-66`: a random
anisotropic up-scale of 1.55-1.70x (area interpolation) followed by a random
crop to the output size, with fx/fy/cx/cy adjusted accordingly. All of this
runs on host CPU (numpy/cv2) in prefetch threads; the GPU only ever sees
fixed-shape uint8 batches.
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


def _imread(path: str) -> np.ndarray:
    if _HAS_CV2:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise OSError(f"cannot read image {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def _resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    if _HAS_CV2:
        # cv2's area filter takes at most 4 channels; each channel is
        # resized on its own, so groups of 3 give the same result.
        groups = [cv2.resize(np.ascontiguousarray(img[..., c:c + 3]), (w, h),
                             interpolation=cv2.INTER_AREA).reshape(h, w, -1)
                  for c in range(0, img.shape[2], 3)]
        return np.concatenate(groups, axis=2)
    from PIL import Image
    return np.asarray(
        Image.fromarray(img).resize((w, h), Image.Resampling.BOX))


def split_sequence_image(views: np.ndarray, sequence_length: int,
                         frame_width: int) -> tuple[np.ndarray, np.ndarray]:
    """Split a horizontally concatenated sequence into (tgt, src_concat).

    Middle frame is the target; sources are channel-concatenated in frame
    order (`sequence_folders.py:12-28` with its fixed src_ids=[0, 2]).
    """
    if views.shape[1] != sequence_length * frame_width:
        raise ValueError(f"image of width {views.shape[1]} is not "
                         f"{sequence_length} frames of {frame_width}")
    mid = sequence_length // 2
    tgt = views[:, frame_width * mid:frame_width * (mid + 1)]
    srcs = [views[:, frame_width * i:frame_width * (i + 1)]
            for i in range(sequence_length) if i != mid]
    return tgt, np.concatenate(srcs, axis=2)


def read_intrinsics(cam_path: str) -> np.ndarray:
    """9 comma-separated numbers -> (3, 3) K (`sequence_folders.py:30-33`)."""
    with open(cam_path) as f:
        first = f.readline().split()[0]
    return np.array(first.split(","), np.float32).reshape(3, 3)


def scale_and_crop(images: np.ndarray, intrinsics: np.ndarray,
                   out_h: int, out_w: int, rng: np.random.RandomState
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Random 1.55-1.70x anisotropic area upscale + random crop, with the
    intrinsics updated (`sequence_folders.py:44-66`)."""
    k = intrinsics.copy()
    in_h, in_w = images.shape[:2]
    x_scale, y_scale = rng.uniform(1.55, 1.70, 2)
    scaled_h, scaled_w = int(in_h * y_scale), int(in_w * x_scale)
    k[0] *= x_scale
    k[1] *= y_scale

    scaled = _resize_area(images, scaled_h, scaled_w)
    off_y = rng.randint(scaled_h - out_h + 1)
    off_x = rng.randint(scaled_w - out_w + 1)
    cropped = scaled[off_y:off_y + out_h, off_x:off_x + out_w]
    k[0, 2] -= off_x
    k[1, 2] -= off_y
    return cropped, k


class SequenceDataset:
    """Indexable KITTI-format sequence dataset producing training samples
    ``{"tgt": (H,W,3) u8, "src": (H,W,3*(L-1)) u8, "intrinsics": (3,3) f32}``.
    """

    def __init__(self, root: str, split: str = "train",
                 sequence_length: int = 3, img_width: int = 416,
                 img_height: int = 128, frame_width: int = 416,
                 augment: bool = True, seed: int = 8964):
        self.root = root
        self.sequence_length = sequence_length
        self.img_width = img_width
        self.img_height = img_height
        self.frame_width = frame_width
        self.augment = augment
        self._rng = np.random.RandomState(seed)

        index_file = os.path.join(root, f"{split}.txt")
        names = []
        with open(index_file) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                names.append(os.path.join(root, parts[0], parts[1])
                             if len(parts) > 1 else os.path.join(root, parts[0]))
        self.example_names = sorted(names)

    def __len__(self) -> int:
        return len(self.example_names)

    def __getitem__(self, index: int) -> dict:
        name = self.example_names[index]
        views = _imread(name + ".jpg")
        intrinsics = read_intrinsics(name + "_cam.txt")
        tgt, src = split_sequence_image(views, self.sequence_length,
                                        self.frame_width)
        stacked = np.concatenate([tgt, src], axis=2)
        if self.augment:
            stacked, intrinsics = scale_and_crop(
                stacked, intrinsics, self.img_height, self.img_width,
                self._rng)
        elif stacked.shape[:2] != (self.img_height, self.img_width):
            scale_x = self.img_width / stacked.shape[1]
            scale_y = self.img_height / stacked.shape[0]
            stacked = _resize_area(stacked, self.img_height, self.img_width)
            intrinsics = intrinsics.copy()
            intrinsics[0] *= scale_x
            intrinsics[1] *= scale_y
        return {"tgt": stacked[..., :3], "src": stacked[..., 3:],
                "intrinsics": intrinsics}


class EvalSequenceDataset:
    """Inference-time 3-view loader over a flat directory of frames.

    Mirrors `testSequenceFolder` (`sequence_folders.py:148-208`): each frame
    is the target, with the previous/next frames (edge-clamped) as sources,
    all area-resized to the working resolution.
    """

    def __init__(self, image_paths: list[str], img_width: int = 416,
                 img_height: int = 128):
        self.paths = sorted(image_paths)
        self.img_width = img_width
        self.img_height = img_height

    def __len__(self) -> int:
        return len(self.paths)

    def _load(self, index: int) -> np.ndarray:
        img = _imread(self.paths[index])
        return _resize_area(img, self.img_height, self.img_width)

    def __getitem__(self, index: int) -> dict:
        tgt = self._load(index)
        srcs = []
        for off in (-1, 1):
            j = min(len(self.paths) - 1, max(0, index + off))
            srcs.append(self._load(j))
        return {"tgt": tgt, "src": np.concatenate(srcs, axis=2)}


def batch_iterator(dataset, batch_size: int, *, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True,
                   loop: bool = False, part: tuple[int, int] | None = None,
                   num_threads: int = 1) -> Iterator[dict]:
    """Collate dataset samples into dict-of-stacked-arrays batches.

    ``part`` = (size, offset) reads only those samples of each batch: a
    rank's part of each global batch
    (``parallel/multihost.per_host_batch_slice``). Every rank shuffles with
    the same ``seed``, so the ranks' parts make up the global batches.
    ``num_threads`` > 1 decodes as many batches at once on threads, and
    yields them in order (a dataset's augmentation then draws in the order
    the threads ask for samples)."""
    rng = np.random.RandomState(seed)
    per, off = part or (batch_size, 0)

    def indices() -> Iterator[np.ndarray]:
        while True:
            order = np.arange(len(dataset))
            if shuffle:
                rng.shuffle(order)
            for start in range(0, len(order), batch_size):
                idx = order[start:start + batch_size]
                if len(idx) < batch_size and drop_last:
                    continue
                yield idx[off:off + per]
            if not loop:
                return

    def load(idx: np.ndarray) -> dict:
        samples = [dataset[int(i)] for i in idx]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    if num_threads <= 1:
        yield from map(load, indices())
        return
    with ThreadPoolExecutor(num_threads) as pool:
        pending: collections.deque = collections.deque()
        for idx in indices():
            pending.append(pool.submit(load, idx))
            if len(pending) >= num_threads:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
