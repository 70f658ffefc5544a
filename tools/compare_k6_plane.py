#!/usr/bin/env python3
"""K6 (the splat) of the parent commit against this tree's, on one card.

Usage, from the repository root on a machine with an NVIDIA GPU:

    mkdir -p outputs/parent && git archive <parent> \
        sndepth_tpu_torch/kernels/csrc | tar -x -C outputs/parent
    python3 tools/compare_k6_plane.py \
        outputs/parent/sndepth_tpu_torch/kernels/csrc

Builds both ``warp.cu`` with ``kernels/build.py``'s flags, then on the
splat's calls of a stage-2 step (a flow warped by a flow, B = 64 pairs, the
four scales, edge_zero) and on what a UniAD train step's frame (the
reference config, six cameras at 224x416, a 200x200 BEV) hands it (every
deformable-attention level and both DCN stages, zero_pad): each version's
largest distance from the plain version, as a share of chip_smoke's
calibrated tolerance (1e-5 plus 4 times the plain version's distance from a
float64 evaluation), over ``--reps`` cotangents, and each version timed in
turn (parent, tree, tree, parent; CUDA events behind a spin, median of 10).
Prints one JSON line a case and writes them all to
``chiprun_out/compare_k6_plane.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build_parent(csrc: str) -> ctypes.CDLL:
    from sndepth_tpu_torch.kernels import build
    out = os.path.join(build.BUILD_DIR, "libwarp_parent.so")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    proc = subprocess.run(
        [build.nvcc_path(), *build.nvcc_flags("warp.cu"), "-o", out,
         os.path.join(csrc, "warp.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr)
    lib = ctypes.CDLL(out)
    lib.warp_splat_launch.restype = ctypes.c_int
    lib.warp_splat_launch.argtypes = ([ctypes.c_void_p] * 3
                                      + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return lib


def _splat_with(lib, coords, g, hs: int, ws: int, mode: str):
    import torch
    from sndepth_tpu_torch.kernels import warp as K5
    b, c, ht, wt = g.shape
    out = g.new_empty((b, c, hs, ws))
    rc = lib.warp_splat_launch(
        coords.data_ptr(), g.data_ptr(), out.data_ptr(), b, c, hs, ws, ht, wt,
        K5.MODES[mode], 2**31 - 1,
        torch._C._cuda_getCurrentRawStream(g.get_device()))
    if rc != 0:
        raise RuntimeError(f"parent splat launch failed: {rc}")
    return out


def _cases():
    """(label, mode, imgs, coords): the stage-2 flow splats and the UniAD
    train frame's sampler calls."""
    import chip_smoke as c
    import torch
    from sndepth_tpu_torch.cli.profile_step import uniad_frame
    from sndepth_tpu_torch.ops.warp import pixel_grid
    gen = torch.Generator().manual_seed(61)
    cases = []
    for s, (_, _, cf, cb) in enumerate(c._pair_inputs(c.FLOW_BATCH, 21, gen)):
        h, w = c.SCALES[s]
        cases.append((f"stage-2 flow {2 * c.FLOW_BATCH}x2x{h}x{w}",
                      "edge_zero", (cb - pixel_grid(h, w, device=c.DEV))
                      .contiguous(), cf))
    model, _, _, frame = uniad_frame(*c.UNIAD_SMALL_HW, c.DEV, seed=55)
    frame()
    for label, (imgs, coords) in c._record_sampler_calls(frame).items():
        if "shift" not in label:
            cases.append((f"UniAD train {label}", "zero_pad", imgs, coords))
    del model, frame
    return cases


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("parent_csrc")
    p.add_argument("--reps", type=int, default=8)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as c
    from sndepth_tpu_torch.kernels import warp as K5
    smi = c.phase_env()
    parent = _build_parent(args.parent_csrc)
    tree = K5._library()
    gen = torch.Generator().manual_seed(62)
    rows = []
    for label, mode, imgs, coords in _cases():
        b, ch, hs, ws = imgs.shape
        ratios = {"parent": [], "tree": []}
        for _ in range(args.reps):
            g = torch.randn(b, ch, *coords.shape[2:], generator=gen).to(c.DEV)
            d_p = K5.warp_splat_reference(coords, g, hs, ws, mode)
            d_64 = K5.warp_splat_reference(coords.double(), g.double(), hs,
                                           ws, mode)
            tol = 1e-5 + 4.0 * c._max_err(d_p.double(), d_64)
            for name, lib in (("parent", parent), ("tree", tree)):
                d_k = _splat_with(lib, coords, g, hs, ws, mode)
                torch.cuda.synchronize()
                c._assert_finite(f"K6 {name} {label}", d_k)
                ratios[name].append(c._max_err(d_k, d_p) / tol)
            del d_p, d_64
        g = torch.randn(b, ch, *coords.shape[2:], generator=gen).to(c.DEV)
        times = {}
        for name in ("parent", "tree", "tree", "parent"):
            lib = parent if name == "parent" else tree
            times.setdefault(name, []).append(c.time_ms(
                lambda: _splat_with(lib, coords, g, hs, ws, mode), 10))
        rows.append({"case": label, "imgs": list(imgs.shape),
                     "coords": list(coords.shape),
                     "path": c._splat_path(hs, ws),
                     "err_over_tol": {k: max(v) for k, v in ratios.items()},
                     "ms": times})
        print(json.dumps(rows[-1]), flush=True)
        del g
        torch.cuda.empty_cache()
    result = {"nvidia_smi": smi, "rows": rows}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "compare_k6_plane.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
