"""CLI: reference PyTorch checkpoints to the files the port's CLIs read.

Counterpart of ``python -m sndepth_tpu.cli.convert_weights``, with its
seven families and flags. The port keeps the reference's key names, so a
conversion strips the wrappers' prefixes (``module.``, ``backbone.``,
``first_stage_model.``, ``encoder.original_model.`` -> ``encoder.``),
keeps the keys of the port's model, and refuses a checkpoint that lacks
one (the result loads with ``strict=True``):

    geonet  rigid_depth_*.pth + rigid_pose_*.pth [+ flow_*.pth] ->
            step_00000000.pt, the nets' state dicts alone (params-only:
            ``train.checkpoint.restore_params_or_state`` and the
            ``--ckpt_dir`` of ``evaluate_depth`` / ``export_model`` graft it)
    nnet    nyu.pt (``encoder.original_model.*``, ``decoder.*`` under
            ``"model"``) -> nnet.pth (``evaluate_normals --ckpt_dir``)
    raft3d  -> raft3d.pth (``kitti_submission`` / ``export_model``)
    vae     -> vae.pth (AutoencoderKL)
    motion  best.pt (a pickled module or a state dict) -> motion.pth
            (``evaluate_motion`` / ``predict_motion --ckpt_dir``)
    dino    dino_deitsmall16_pretrain.pth -> dino.pth (the ViT-S/16)
    uniad   -> uniad.pth (the track model; the full UniAD checkpoint's
            motion / occupancy / planning heads are left out)

Usage:
    python -m sndepth_tpu_torch.cli.convert_weights geonet \\
        --depth rigid_depth_35000.pth --pose rigid_pose_35000.pth \\
        --out converted/geonet
    python -m sndepth_tpu_torch.cli.convert_weights nnet \\
        --ckpt checkpoints/nyu.pt --out converted/nnet
"""

from __future__ import annotations

import argparse
import os

OUT_FILES = {"geonet": "step_00000000.pt", "nnet": "nnet.pth",
             "raft3d": "raft3d.pth", "vae": "vae.pth",
             "motion": "motion.pth", "dino": "dino.pth",
             "uniad": "uniad.pth"}


def _strip(sd: dict, prefix: str) -> dict:
    return {k.removeprefix(prefix): v for k, v in sd.items()}


def select(sd: dict, model, what: str) -> dict:
    """The entries of ``sd`` that ``model``'s state dict has, in its
    order; raises ``KeyError`` on a key it lacks."""
    keys = list(model.state_dict())
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"{what} lacks {len(missing)} of the model's "
                       f"{len(keys)} keys, the first: {missing[0]}")
    return {k: sd[k] for k in keys}


def _load(path: str, pickled: bool = False):
    import torch
    return torch.load(path, map_location="cpu", weights_only=not pickled)


def default_model(kind: str, architecture: str = "GN"):
    """The port's full-size model of a family (random weights): what a
    converted file is checked against."""
    if kind == "nnet":
        from sndepth_tpu_torch.models.nnet import NNET
        return NNET(architecture)
    if kind == "raft3d":
        from sndepth_tpu_torch.models.raft3d import RAFT3D
        return RAFT3D()
    if kind == "vae":
        from sndepth_tpu_torch.models.vae import AutoencoderKL
        return AutoencoderKL()
    if kind == "motion":
        from sndepth_tpu_torch.models.motionseg import MotionFusionNet
        return MotionFusionNet()
    if kind == "dino":
        from sndepth_tpu_torch.models.vit import ViT
        return ViT()
    if kind == "uniad":
        from sndepth_tpu_torch.models.uniad_track import (
            uniad_reference_config)
        return uniad_reference_config()
    raise ValueError(f"no single model for {kind!r}")


def convert_geonet(depth: str, pose: str, flow: str | None = None,
                   models: dict | None = None) -> dict:
    """{"disp_net", "pose_net"[, "flow_net"]} state dicts from the
    reference's ``rigid_depth`` / ``rigid_pose`` (/ ``flow``) files
    (`baseline.py:1218-1232`: under ``*_net_state_dict`` or bare)."""
    if models is None:
        from sndepth_tpu_torch.models.dispnet import DispNetS
        from sndepth_tpu_torch.models.flownet import FlowNet
        from sndepth_tpu_torch.models.posenet import PoseNet
        from sndepth_tpu_torch.train.geonet import FLOW_IN_CHANNELS
        models = {"disp_net": DispNetS(), "pose_net": PoseNet(num_source=2),
                  "flow_net": FlowNet(FLOW_IN_CHANNELS, 0.1)}
    out = {}
    for key, path in (("disp_net", depth), ("pose_net", pose),
                      ("flow_net", flow)):
        if path is None:
            continue
        ckpt = _load(path)
        sd = _strip(ckpt.get(f"{key}_state_dict", ckpt), "module.")
        out[key] = select(sd, models[key], path)
    return out


def convert_checkpoint(kind: str, path: str, model=None,
                       architecture: str = "GN") -> dict:
    """The port's state dict of family ``kind`` (not ``geonet``) from the
    reference checkpoint at ``path``, checked against ``model`` (default:
    :func:`default_model`)."""
    if model is None:
        model = default_model(kind, architecture)
    if kind == "motion":
        obj = _load(path, pickled=True)
        sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    else:
        ckpt = _load(path)
        sd = {"nnet": lambda: ckpt.get("model", ckpt),
              "raft3d": lambda: ckpt.get("model", ckpt.get("state_dict",
                                                           ckpt)),
              "vae": lambda: ckpt.get("state_dict", ckpt),
              "dino": lambda: ckpt.get("model", ckpt.get("teacher", ckpt)),
              "uniad": lambda: ckpt.get("state_dict", ckpt)}[kind]()
    sd = _strip(sd, "module.")
    if kind == "nnet":
        sd = {("encoder." + k[len("encoder.original_model."):]
               if k.startswith("encoder.original_model.") else k): v
              for k, v in sd.items()}
        keys = [k for k in model.state_dict()
                if k.startswith(("encoder.", "decoder."))]
        missing = [k for k in keys if k not in sd]
        if missing:
            raise KeyError(f"{path} lacks {len(missing)} encoder / decoder "
                           f"keys, the first: {missing[0]}")
        return {k: sd[k] for k in keys}
    if kind == "vae":
        first = {k[len("first_stage_model."):]: v for k, v in sd.items()
                 if k.startswith("first_stage_model.")}
        sd = first or sd
    if kind == "dino":
        sd = _strip(sd, "backbone.")
    return select(sd, model, path)


def main(argv=None) -> str:
    """Convert; returns the written file's path."""
    p = argparse.ArgumentParser(description="reference -> port converter")
    sub = p.add_subparsers(dest="kind", required=True)
    g = sub.add_parser("geonet", help="DispNetS + PoseNet pair")
    g.add_argument("--depth", required=True, help="rigid_depth_*.pth")
    g.add_argument("--pose", required=True, help="rigid_pose_*.pth")
    g.add_argument("--flow", default=None,
                   help="optional stage-2 flow_*.pth (FlowNet)")
    g.add_argument("--out", required=True, help="output checkpoint dir")
    n = sub.add_parser("nnet", help="normal net (nyu.pt)")
    n.add_argument("--ckpt", required=True, help="nyu.pt path")
    n.add_argument("--architecture", default="GN", choices=["GN", "BN"])
    n.add_argument("--out", required=True, help="output checkpoint dir")
    for kind, helptext in (
            ("raft3d", "RAFT3D scene-flow .pth"),
            ("vae", "AutoencoderKL ckpt (first_stage_model. stripped)"),
            ("motion", "MotionFusionNet best.pt"),
            ("dino", "DINO ViT-S/16 checkpoint"),
            ("uniad", "UniAD track .pth (R101+BEVFormer+QIM+membank)")):
        s = sub.add_parser(kind, help=helptext)
        s.add_argument("--ckpt", required=True)
        s.add_argument("--out", required=True, help="output checkpoint dir")
    args = p.parse_args(argv)

    import torch

    from sndepth_tpu_torch.train import checkpoint as ckpt_lib
    if args.kind == "geonet":
        path = ckpt_lib.save_checkpoint(
            args.out, convert_geonet(args.depth, args.pose, args.flow), 0)
    else:
        sd = convert_checkpoint(args.kind, args.ckpt,
                                architecture=getattr(args, "architecture",
                                                     "GN"))
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, OUT_FILES[args.kind])
        torch.save(sd, path + ".tmp")
        os.replace(path + ".tmp", path)
    print(f"converted -> {path}")
    return path


if __name__ == "__main__":
    main()
