"""CLI: UniAD tracker clip training on one GPU.

The flags and log lines of ``python -m sndepth_tpu.cli.train_uniad``, plus
``--device``: :mod:`sndepth_tpu_torch.train.uniad` on the JAX CLI's
synthetic drifting-boxes clip (the same clip every step), with the small
config under ``--small`` and else the reference config. ``--remat``
recomputes each encoder and decoder sublayer in the backward pass. The
checkpoint goes to ``--ckpt_dir`` at the end: ``uniad.pth`` holds the model
in the reference's key names.

Usage:
    python -m sndepth_tpu_torch.cli.train_uniad --small --max_steps 10
    python -m sndepth_tpu_torch.cli.train_uniad --remat --t_frames 2 \\
        --img_size 224 --max_steps 2
"""

from __future__ import annotations

import argparse
import time


def small_model(dtype=None, remat: bool = False):
    """The JAX CLI's ``--small`` config."""
    import torch
    from sndepth_tpu_torch.models.uniad_track import UniADTrack
    return UniADTrack(num_query=12, num_classes=3, embed_dims=32, bev_h=4,
                      bev_w=4, num_cams=2, encoder_layers=1, decoder_layers=2,
                      backbone_blocks=(1, 1, 1, 1), mem_len=2,
                      dtype=dtype or torch.float32, remat=remat)


def main(argv=None):
    """Train; returns (the final UniADTrainState, the logged records)."""
    p = argparse.ArgumentParser(description="UniAD tracker clip training")
    p.add_argument("--ckpt_dir", default="checkpoints/uniad")
    p.add_argument("--max_steps", default=50, type=int)
    p.add_argument("--log_every", default=5, type=int)
    p.add_argument("--t_frames", default=3, type=int)
    p.add_argument("--num_gt", default=4, type=int)
    p.add_argument("--img_size", default=64, type=int)
    p.add_argument("--lr", default=2e-4, type=float)
    p.add_argument("--small", action="store_true",
                   help="small model config (for smoke runs)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--remat", action="store_true",
                   help="recompute encoder/decoder sublayers in the backward "
                        "pass (reference-scale memory)")
    p.add_argument("--seed", default=0, type=int,
                   help="weights and QIM draws")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    import torch

    from sndepth_tpu_torch.models.uniad_track import (init_weights,
                                                      uniad_reference_config)
    from sndepth_tpu_torch.train import loop
    from sndepth_tpu_torch.train import uniad as tu

    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.small:
        model = small_model(dtype, args.remat)
    else:
        model = uniad_reference_config(dtype=dtype, remat=args.remat)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    clip = tu.synthetic_clip(model, t_frames=args.t_frames, ng=args.num_gt,
                             img_hw=(args.img_size, args.img_size))
    clip = tu.clip_to(clip, device)
    state = tu.create_train_state(model, device, args.lr, args.seed)
    records = []
    t0 = time.perf_counter()
    for i in range(1, args.max_steps + 1):
        metrics = tu.train_step(state, clip)
        if i % args.log_every == 0 or i == args.max_steps:
            record = {k: float(v) for k, v in sorted(metrics.items())}
            records.append({"step": i, **record})
            print(f"step {i}/{args.max_steps} " + " ".join(
                f"{k}={v:.4f}" for k, v in record.items()), flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"trained {state.calls} steps ({state.step} applied) in "
          f"{dt:.1f}s ({dt / max(state.calls, 1) * 1e3:.0f} ms/step)",
          flush=True)
    print(f"checkpoint -> {loop.save_uniad_checkpoint(state, args.ckpt_dir)}")
    return state, records


if __name__ == "__main__":
    main()
