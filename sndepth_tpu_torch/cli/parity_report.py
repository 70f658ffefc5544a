"""CLI: one-command metric parity report.

Counterpart of ``python -m sndepth_tpu.cli.parity_report`` (the
``docs/PARITY.md`` recipe): given a directory of released reference
checkpoints and one of datasets, convert each family found
(``cli/convert_weights.py``), run its evaluation CLI and write one table:
markdown on stdout and ``report.json`` (``{"metrics": ..., "skipped":
...}``, the JAX CLI's keys). A family whose checkpoint or data is missing
is reported as skipped, so the command runs today, every family skipped,
and gives the whole table once KITTI / NYU data is there.

Expected layout:

    <checkpoints>/rigid_depth_*.pth + rigid_pose_*.pth   GeoNet
    <checkpoints>/nyu.pt                                 NNET normals
    <checkpoints>/best.pt                                MotionFusionNet
    <data>/kitti_eigen_gt.npz + eigen_test_files.txt     depth eval
    <data>/nyu_normals/                                  normals eval
    <data>/kitti_motion/                                 motion eval

Usage:
    python -m sndepth_tpu_torch.cli.parity_report \\
        --checkpoints_dir checkpoints --data_dir data
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil


def _convert(kind: str, out_dir: str, **kw) -> str:
    """Convert into ``<out_dir>/converted/<kind>`` unless a conversion of
    the same source files (paths and modification times) is there."""
    from sndepth_tpu_torch.cli import convert_weights
    out = os.path.join(out_dir, "converted", kind)
    srcs = sorted(str(v) for v in kw.values())
    stamp = json.dumps([[s, os.path.getmtime(s)] for s in srcs
                        if os.path.exists(s)])
    stamp_file = out + ".src.json"
    if os.path.isdir(out) and os.path.exists(stamp_file):
        with open(stamp_file) as f:
            if f.read() == stamp:
                return out
    tmp = out + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    argv = [kind]
    for k, v in kw.items():
        argv += [f"--{k}", v]
    convert_weights.main(argv + ["--out", tmp])
    if os.path.isdir(out):
        shutil.rmtree(out)
    os.replace(tmp, out)
    with open(stamp_file, "w") as f:
        f.write(stamp)
    return out


def main(argv=None) -> dict:
    """Write the report; returns it."""
    p = argparse.ArgumentParser(description="one-command parity report")
    p.add_argument("--checkpoints_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_dir", default="outputs/parity_report")
    p.add_argument("--img_height", default=128, type=int)
    p.add_argument("--img_width", default=416, type=int)
    p.add_argument("--nyu_height", default=480, type=int)
    p.add_argument("--nyu_width", default=640, type=int)
    p.add_argument("--device", default="cuda",
                   help="device the evaluations run on (cuda, cpu)")
    args = p.parse_args(argv)

    ck, dd = args.checkpoints_dir, args.data_dir
    os.makedirs(args.out_dir, exist_ok=True)
    report: dict = {}
    skipped: dict = {}

    def missing(*paths):
        return [q for q in paths if not (os.path.exists(q) or glob.glob(q))]

    depth_ck = sorted(glob.glob(os.path.join(ck, "rigid_depth_*.pth")))
    pose_ck = sorted(glob.glob(os.path.join(ck, "rigid_pose_*.pth")))
    gt_file = os.path.join(dd, "kitti_eigen_gt.npz")
    img_list = os.path.join(dd, "eigen_test_files.txt")
    lack = (([] if depth_ck and pose_ck else ["rigid_depth/pose .pth"])
            + missing(gt_file, img_list))
    if not lack:
        from sndepth_tpu_torch.cli import evaluate_depth
        conv = _convert("geonet", args.out_dir, depth=depth_ck[-1],
                        pose=pose_ck[-1])
        mj = os.path.join(args.out_dir, "depth_metrics.json")
        evaluate_depth.main([
            "--gt_file", gt_file, "--img_list", img_list,
            "--ckpt_dir", conv, "--metrics_json", mj,
            "--img_height", str(args.img_height),
            "--img_width", str(args.img_width), "--device", args.device])
        with open(mj) as f:
            report["kitti_eigen_depth"] = json.load(f)
    else:
        skipped["kitti_eigen_depth"] = lack

    nyu_ck = os.path.join(ck, "nyu.pt")
    nyu_data = os.path.join(dd, "nyu_normals")
    lack = missing(nyu_ck, nyu_data)
    if not lack:
        from sndepth_tpu_torch.cli import evaluate_normals
        conv = _convert("nnet", args.out_dir, ckpt=nyu_ck)
        mj = os.path.join(args.out_dir, "normal_metrics.json")
        evaluate_normals.main([
            "--data_dir", nyu_data, "--split", "test",
            "--ckpt_dir", conv, "--metrics_json", mj,
            "--img_height", str(args.nyu_height),
            "--img_width", str(args.nyu_width),
            "--log_file", os.path.join(args.out_dir, "normal_eval.txt"),
            "--device", args.device])
        with open(mj) as f:
            report["nyu_normals"] = json.load(f)
    else:
        skipped["nyu_normals"] = lack

    mot_ck = os.path.join(ck, "best.pt")
    mot_data = os.path.join(dd, "kitti_motion")
    lack = missing(mot_ck, mot_data)
    if not lack:
        from sndepth_tpu_torch.cli import evaluate_motion
        conv = _convert("motion", args.out_dir, ckpt=mot_ck)
        mj = os.path.join(args.out_dir, "motion_metrics.json")
        evaluate_motion.main([
            "--data_dir", mot_data, "--ckpt_dir", conv,
            "--metrics_json", mj, "--device", args.device])
        with open(mj) as f:
            report["kitti_motion_miou"] = json.load(f)
    else:
        skipped["kitti_motion_miou"] = lack

    print("\n# Parity report\n")
    print("| benchmark | metric | value |")
    print("|---|---|---|")
    for bench, metrics in report.items():
        for k, v in metrics.items():
            print(f"| {bench} | {k} | {v:.4f} |")
    for bench, lack in skipped.items():
        print(f"| {bench} | SKIPPED | missing: {', '.join(lack)} |")
    out = {"metrics": report, "skipped": skipped}
    path = os.path.join(args.out_dir, "report.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"\nwrote {path}")
    return out


if __name__ == "__main__":
    main()
