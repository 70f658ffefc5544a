#!/usr/bin/env python3
"""K5 (the gather) and K5b (its coordinate gradient) of the parent commit
against this tree's, on one card.

Usage, from the repository root on a machine with an NVIDIA GPU:

    mkdir -p outputs/parent && git archive <parent> \
        sndepth_tpu_torch/kernels/csrc | tar -x -C outputs/parent
    python3 tools/compare_k5.py outputs/parent/sndepth_tpu_torch/kernels/csrc \
        [--variant NAME=-DFLAG=VALUE ...] [--only SUBSTRING ...] [--rounds N]

Builds the parent's ``warp.cu`` and the tree's with ``kernels/build.py``'s
flags (and each ``--variant``: the tree's source with more ``-D`` flags,
for an ``#ifdef`` that an experiment adds to its own checkout), all at
once. Then, at every
shape ``chip_smoke.py`` times K5 and K5b at: GeoNet stage 2 (the image
warp of scale 0 and the flows warped by flows at the four scales, B = 64,
in both modes), RAFT3D's C = 1 grids at 128x416 and 376x1248, RAFT2D-Large's
lookup at 128x416 and 376x1248 (the four levels of the last iteration), and
every distinct sampler call of a UniAD reference frame (zero_pad). For each
shape and version: the largest distance of the gather and of the
coordinate gradient from their plain versions, whether the gather equals
its plain version, whether two coordinate-gradient calls are bit-equal; the
tree's launch configuration; each version timed in turn (parent, tree,
variants, variants reversed, tree, parent, ``--rounds`` times over; CUDA
events behind a spin, median of 10), beside ``F.grid_sample`` and ``grid_sampler_2d_backward``
asked for the grid's gradient alone (zero_pad shapes). Prints one JSON
line a shape and writes them all to ``chiprun_out/compare_k5.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name, pointers in (("warp_gather_launch", 3),
                           ("warp_coord_grad_launch", 4)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
    return lib


def _build(source: str, name: str, extra: list[str]) -> tuple[str, str]:
    """``source`` built with ``warp.cu``'s flags and ``extra`` into
    ``build/libwarp_<name>.so``; returns (path, compiler report)."""
    from sndepth_tpu_torch.kernels import build
    out = os.path.join(build.BUILD_DIR, f"libwarp_{name}.so")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    proc = subprocess.run(
        [build.nvcc_path(), *build.nvcc_flags("warp.cu"), *extra, "-o", out,
         source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: {proc.stderr}")
    return out, proc.stderr


def _libraries(parent_csrc: str, variants: dict) -> tuple[dict, dict]:
    """{version: library}: the parent, the tree (through kernels/build.py)
    and each variant, compiled in parallel; and {version: the compiler's
    register and spill lines}."""
    from sndepth_tpu_torch.kernels import build
    from sndepth_tpu_torch.kernels import warp as K5
    tree_src = os.path.join(build.CSRC, "warp.cu")
    jobs = {"parent": (os.path.join(parent_csrc, "warp.cu"), [])}
    jobs.update({k: (tree_src, v) for k, v in variants.items()})
    with ThreadPoolExecutor(max_workers=len(jobs) + 1) as pool:
        tree = pool.submit(build.compile_source, "warp.cu")
        built = {k: pool.submit(_build, src, k, extra)
                 for k, (src, extra) in jobs.items()}
        reports = {"tree": tree.result()[1]}
        reports.update({k: f.result()[1] for k, f in built.items()})
    libs = {"parent": _bind(built["parent"].result()[0]),
            "tree": K5._library()}
    libs.update({k: _bind(built[k].result()[0]) for k in variants})
    ptxas = {k: [ln.strip() for ln in r.splitlines()
                 if "Compiling entry" in ln or "registers" in ln
                 or "spill" in ln] for k, r in reports.items()}
    return libs, ptxas


def _call(lib, grad: bool, imgs, coords, g, mode: str):
    import torch
    from sndepth_tpu_torch.kernels import warp as K5
    b, c, hs, ws = imgs.shape
    ht, wt = coords.shape[2:]
    out = imgs.new_empty((b, 2 if grad else c, ht, wt))
    stream = torch._C._cuda_getCurrentRawStream(imgs.get_device())
    if grad:
        rc = lib.warp_coord_grad_launch(
            imgs.data_ptr(), coords.data_ptr(), g.data_ptr(), out.data_ptr(),
            b, c, hs, ws, ht, wt, K5.MODES[mode], stream)
    else:
        rc = lib.warp_gather_launch(
            imgs.data_ptr(), coords.data_ptr(), out.data_ptr(), b, c, hs, ws,
            ht, wt, K5.MODES[mode], stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return out


def _cases(only: list[str]):
    """(label, mode, imgs, coords) at every shape, yielded one at a time so
    that the UniAD model is built only when its shapes are wanted."""
    import torch

    import chip_smoke as c
    from sndepth_tpu_torch.ops.warp import pixel_grid
    from sndepth_tpu_torch.pipelines import Raft2DFlowStage

    def wanted(label):
        return not only or any(s in label for s in only)

    gen = torch.Generator().manual_seed(61)
    pairs = c._pair_inputs(c.FLOW_BATCH, 31, gen)
    for s, (h, w) in enumerate(c.SCALES):
        _, src, cf, cb = pairs[s]
        n = src.shape[0]
        flow = (cb - pixel_grid(h, w, device=c.DEV)).contiguous()
        for mode in ("edge_zero", "zero_pad"):
            if s == 0 and wanted(f"GeoNet image {mode}"):
                yield f"GeoNet image {n}x3x{h}x{w} {mode}", mode, src, cf
            if wanted(f"GeoNet flow {mode}"):
                yield f"GeoNet flow {n}x2x{h}x{w} {mode}", mode, flow, cf
    del pairs
    for h, w in c.RAFT_SIZES:
        depth, coords = c._sampler_inputs(h // 8, w // 8, gen)
        label = f"RAFT3D 1x1x{h // 8}x{w // 8}"
        if wanted(label):
            yield label, "zero_pad", depth, coords
    for h, w in c.RAFT2D_HW:
        if not wanted(f"RAFT2D-Large lookup {h}x{w}"):
            continue
        stage = Raft2DFlowStage(iters=c.RAFT2D_ITERS, arch="large",
                                device=c.DEV)
        calls = c._lookup_inputs(stage.model, h, w, seed=h)
        del stage
        for level, (imgs, coords) in enumerate(calls):
            yield (f"RAFT2D-Large lookup {h}x{w} level {level}", "zero_pad",
                   imgs, coords)
    if not only or not all(s.startswith(("GeoNet", "RAFT")) for s in only):
        from sndepth_tpu_torch.cli.profile_step import uniad_frame
        model, _, _, frame = uniad_frame(*c.UNIAD_HW, c.DEV, seed=55)
        frame()
        calls = c._record_sampler_calls(frame)
        del model, frame
        torch.cuda.empty_cache()
        for label, (imgs, coords) in calls.items():
            if wanted(f"UniAD {label}"):
                yield f"UniAD {label}", "zero_pad", imgs, coords


def _row(label, mode, imgs, coords, libs, gen, rounds: int = 1) -> dict:
    import torch
    import torch.nn.functional as F

    import chip_smoke as c
    from sndepth_tpu_torch.kernels import warp as K5
    b, ch, hs, ws = imgs.shape
    g = torch.randn(b, ch, *coords.shape[2:], generator=gen).to(c.DEV)
    want = K5.warp_gather_reference(imgs, coords, mode)
    d_want = K5.warp_coord_grad_reference(imgs, coords, g, mode)
    x, y = coords[:, 0], coords[:, 1]
    row = {"case": label, "mode": mode, "imgs": list(imgs.shape),
           "coords": list(coords.shape),
           "outside_share": float(((x < -1) | (x > ws) | (y < -1)
                                   | (y > hs)).float().mean()),
           "launch": {"gather": K5.sampler_launch_config(imgs, coords),
                      "coord_grad": K5.sampler_launch_config(imgs, coords,
                                                             g)},
           "checks": {}}
    for name, lib in libs.items():
        got = _call(lib, False, imgs, coords, None, mode)
        d1 = _call(lib, True, imgs, coords, g, mode)
        d2 = _call(lib, True, imgs, coords, g, mode)
        torch.cuda.synchronize()
        row["checks"][name] = {
            "finite": bool(torch.isfinite(got).all()
                           and torch.isfinite(d1).all()),
            "gather_err": c._max_err(got, want),
            "gather_equal_plain": bool(torch.equal(got, want)),
            "coord_grad_err": c._max_err(d1, d_want),
            # chip_smoke's tolerance for K5b.
            "coord_grad_within_tol": bool(torch.allclose(
                d1, d_want, atol=1e-5, rtol=1e-5)),
            "coord_grad_rerun_bit_equal": bool(torch.equal(
                d1.view(torch.int32), d2.view(torch.int32)))}
        del got, d1, d2
    del want, d_want
    order = list(libs)
    order = (order[:1] + order[1:] + order[1:][::-1] + order[:1]) * rounds
    times = {"gather": {}, "coord_grad": {}}
    for name in order:
        for what, grad in (("gather", False), ("coord_grad", True)):
            times[what].setdefault(name, []).append(c.time_ms(
                lambda: _call(libs[name], grad, imgs, coords, g, mode), 10))
    row["ms"] = times
    if mode == "zero_pad":
        norm = torch.stack([coords[:, 0] * (2.0 / (ws - 1)) - 1.0,
                            coords[:, 1] * (2.0 / (hs - 1)) - 1.0], -1)
        bwd = torch.ops.aten.grid_sampler_2d_backward
        row["library_ms"] = {
            "gather": c.time_ms(lambda: F.grid_sample(
                imgs, norm, mode="bilinear", padding_mode="zeros",
                align_corners=True), 10),
            "coord_grad": c.time_ms(lambda: bwd(
                g, imgs, norm, 0, 0, True, [False, True]), 10)}
        del norm
    npix = coords.shape[2] * coords.shape[3]
    row["bound_ms"] = {
        "gather": c._bound(c._nbytes(imgs, coords, g),
                           b * npix * (20 + 7 * ch)),
        "coord_grad": c._bound(c._nbytes(imgs, coords, g, coords),
                               b * npix * (20 + 22 * ch))}
    row["bound_ms"] = {k: max(v["bytes_ms"], v["flops_ms"])
                       for k, v in row["bound_ms"].items()}
    del g
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("parent_csrc")
    p.add_argument("--variant", action="append", default=[],
                   help="NAME=FLAGS: the tree's warp.cu built with FLAGS "
                        "(space-separated), timed beside the others")
    p.add_argument("--only", action="append", default=[],
                   help="time only the shapes whose label holds this")
    p.add_argument("--rounds", type=int, default=1,
                   help="time the versions in turn so many times over, "
                        "for the spread of each version's medians")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as c
    smi = c.phase_env()
    variants = {}
    for spec in args.variant:
        name, _, flags = spec.partition("=")
        variants[name] = flags.split()
    libs, ptxas = _libraries(args.parent_csrc, variants)
    gen = torch.Generator().manual_seed(62)
    rows = []
    out = os.path.join(ROOT, "chiprun_out", "compare_k5.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    for label, mode, imgs, coords in _cases(args.only):
        rows.append(_row(label, mode, imgs, coords, libs, gen, args.rounds))
        print(json.dumps(rows[-1]), flush=True)
        with open(out, "w") as f:
            json.dump({"nvidia_smi": smi, "variants": variants,
                       "ptxas": ptxas, "rows": rows}, f, indent=1)
    return {"nvidia_smi": smi, "rows": rows}


if __name__ == "__main__":
    main()
