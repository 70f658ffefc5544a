"""GeoNet training cells: the port's train step fed through its input
layer, as the body of ``sndepth_tpu_torch/train/loop.train_geonet``'s loop
without checkpoints.

Set-up draws the weights (the benchmark's own, on the device) and the
traffic's pool of distinct batches from the seed, builds one train state,
and drives it through ``setup_steps`` steps through the window's own call
(``train.geonet.train_step``) and feed (``data.prefetch.device_prefetch``
over the pool's uint8 NHWC numpy batches, cycled). The first three are
checked: each step's loss, the first gradient as Adam got it (its first
moment after one step over 1 - beta1) and each leaf's change after three
steps. The same object then runs the window for ``--seconds``: the rate
(the cell's ``rate_metric``) counts the frames of every step completed in
it; a step whose update the port skipped as non-finite counts as failed,
and not in the rate. After the window the port's state is freed and the
plain reference (``reference/<config>.py``) takes the first three batches
from the same weights; its first step also gives the step's convolution
and matrix FLOPs (``FlopCounterMode``) and its notes the hand-written
kernels' work.
"""

from __future__ import annotations

import itertools
import math
import time

import torch

from gpubench import checks, generator, harness, trace, weights, work

CHECKED_STEPS = 3


def model_config(ctx) -> dict:
    """The configuration's model settings with the cell's job (stage)."""
    cfg = dict(ctx.config["model"])
    cfg.update(ctx.cell["job"])
    return cfg


def sizes(cfg: dict) -> dict:
    return {"height": cfg["img_height"], "width": cfg["img_width"],
            "sequence_length": cfg["sequence_length"]}


def weight_rules(ref_mod, cfg: dict) -> list:
    """Xavier-normal weights, zero biases, in the reference's parameter
    order."""
    with torch.device("meta"):
        model = ref_mod.GeoNetReference(cfg)
    rules = []
    for name, p in model.named_parameters():
        if p.dim() >= 2:
            rf = p[0, 0].numel()
            std = math.sqrt(2.0 / ((p.shape[0] + p.shape[1]) * rf))
            rules.append((name, tuple(p.shape), ("normal", std)))
        else:
            rules.append((name, tuple(p.shape), ("const", 0.0)))
    return rules


def draw_weights(ctx, cfg: dict) -> dict:
    return weights.draw(weight_rules(ctx.reference(), cfg), ctx.seed,
                        ctx.device)


def build_state(cfg: dict, state_dict: dict, device):
    """The port's train state on ``device`` with the benchmark's weights."""
    from sndepth_tpu_torch.core.config import GeoNetConfig, apply_precision
    from sndepth_tpu_torch.models.dispnet import DispNetS
    from sndepth_tpu_torch.models.flownet import FlowNet
    from sndepth_tpu_torch.models.posenet import PoseNet
    from sndepth_tpu_torch.train import geonet

    dtype = {"bfloat16": torch.bfloat16,
             "float32": torch.float32}[cfg["compute_dtype"]]
    names = {f.name for f in GeoNetConfig.__dataclass_fields__.values()}
    config = GeoNetConfig(**{**{k: v for k, v in cfg.items() if k in names},
                             "compute_dtype": dtype})
    with torch.device(device):
        disp = DispNetS(dtype=dtype)
        pose = PoseNet(num_source=config.num_source, dtype=dtype)
        flow = (FlowNet(geonet.FLOW_IN_CHANNELS, config.flow_scale_factor,
                        dtype=dtype) if config.train_flow else None)
    state = geonet.TrainState(disp, pose, None, flow)
    for key, net in state.nets().items():
        net.load_state_dict(weights.split(state_dict, key), strict=True)
    state.optimizer = geonet.make_optimizer(config, state.parameters())
    apply_precision(config)
    return state, config


def named_params(state) -> dict:
    return {f"{key}.{n}": p for key, net in state.nets().items()
            for n, p in net.named_parameters()}


class Program:
    """The port's state, its feed and the step the window runs."""

    def __init__(self, ctx, cfg: dict, pool: list, watch=None):
        from sndepth_tpu_torch.data.prefetch import device_prefetch
        state_dict = draw_weights(ctx, cfg)
        if watch is not None:
            watch.mark("weights")
        self.state, self.config = build_state(cfg, state_dict, ctx.device)
        self.feed = device_prefetch(itertools.cycle(pool), ctx.device)
        if watch is not None:
            watch.mark("port state")

    def step(self) -> tuple[float, bool]:
        """One step from the feed: (seconds waited for the batch, whether
        the update was skipped as non-finite)."""
        from sndepth_tpu_torch.train import geonet
        t = time.perf_counter()
        batch = next(self.feed)
        wait = time.perf_counter() - t
        before = self.state.notfinite_count
        self.last = geonet.train_step(self.state, batch, self.config)
        return wait, self.state.notfinite_count > before

    def checked_steps(self, cfg: dict) -> dict:
        """Steps 1-3 with what the check compares."""
        params = named_params(self.state)
        start = {k: p.detach().clone() for k, p in params.items()}
        losses, first_grad = [], None
        for k in range(CHECKED_STEPS):
            self.step()
            losses.append(float(self.last["loss_total"]))
            if k == 0:
                opt = self.state.optimizer.state
                first_grad = checks.leaf_norms(
                    {n: opt[p]["exp_avg"] / (1.0 - cfg["adam_beta1"])
                     if p in opt else torch.zeros_like(p)
                     for n, p in params.items()})
        change = checks.leaf_norms({n: p.detach() - start[n]
                                    for n, p in params.items()})
        return {"losses": losses, "first_grad": first_grad,
                "change": change}


def reference_steps(ctx, cfg: dict, pool: list, precision: str = "float32",
                    record: bool = False) -> dict:
    """The plain reference's first three steps from the same weights and
    batches, TF32 off; with ``record`` its work log and FLOPs too."""
    from torch.utils.flop_counter import FlopCounterMode
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref_mod = ctx.reference()
    start = draw_weights(ctx, cfg)
    trainer = ref_mod.ReferenceTrainer(cfg, start, ctx.device, precision,
                                       chunk=ctx.cell.get("reference_chunk"))
    losses, first_grad, log, flops = [], None, [], None
    for k in range(CHECKED_STEPS):
        if record:
            counter = FlopCounterMode(display=False) if k == 0 else None
            with work.recording() as step_log:
                if counter is not None:
                    with counter:
                        loss, grads = trainer.step(pool[k])
                    flops = float(counter.get_total_flops())
                else:
                    loss, grads = trainer.step(pool[k])
            log += step_log
        else:
            loss, grads = trainer.step(pool[k])
        losses.append(loss)
        if k == 0:
            first_grad = checks.leaf_norms(grads)
    change = checks.leaf_norms({n: p.detach() - start[n]
                                for n, p in trainer.params.items()})
    return {"losses": losses, "first_grad": first_grad, "change": change,
            "log": log, "flops": flops}


def leaf_gaps(got: dict, want: dict) -> tuple[dict, dict]:
    """Each leaf's first-gradient gap, and each moving leaf's change gap
    after three steps."""
    return (checks.leaf_gaps(got["first_grad"], want["first_grad"]),
            checks.leaf_gaps(got["change"], want["change"],
                             checks.moving_leaves(want["first_grad"])))


def compare(got: dict, want: dict) -> dict:
    """The check's numbers: the worst leaf's first-gradient gap and the
    gap that nine leaves in ten stay under (steady where one small leaf,
    a saturated disparity head, swings the worst), the worst and the median
    moving leaf's change gap, and the worst step's loss gap. A cell's
    limits name those it compares; the others are recorded."""
    grad, change = leaf_gaps(got, want)
    return {
        "grad": checks.worst(grad), "grad_p90": checks.share(grad, 0.9),
        "update": checks.worst(change),
        "update_median": checks.share(change, 0.5),
        "loss": max(checks.rel_gap(a, b)
                    for a, b in zip(got["losses"], want["losses"])),
    }


def worst_leaves(got: dict, want: dict, n: int = 3) -> dict:
    """The ``n`` leaves with the widest gaps, for the record."""
    out = {}
    for what, gaps in zip(("grad", "update"), leaf_gaps(got, want)):
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        out[what] = [[name, gap] for name, gap in top]
    return out



def half_batch_step(step):
    """A fault: the step sees the first half of each batch alone, its
    losses means over those rows."""
    def broken(state, batch, config, *args, **kwargs):
        half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return step(state, half, config, *args, **kwargs)
    return broken


def readings(ctx) -> dict:
    """For setting the check's limits, at the cell's own size and without
    a window: the check's numbers of the port, of the control (the
    reference with float8 convolution operands in the port's place) and of
    the port with each fault this cell can have planted (a step that
    leaves the state unchanged reads 1 by construction and is not run)."""
    from sndepth_tpu_torch.train import geonet
    cfg = model_config(ctx)
    pool = generator.generate(ctx.traffic, sizes(cfg), ctx.seed, ctx.device)
    out = {}
    for name, patch in (("program", None),
                        ("half_batch", half_batch_step(geonet.train_step))):
        real = geonet.train_step
        if patch is not None:
            geonet.train_step = patch
        try:
            prog = Program(ctx, cfg, pool)
            out[name] = prog.checked_steps(cfg)
            prog.feed.close()
            del prog
        finally:
            geonet.train_step = real
        harness.free_card()
    want = reference_steps(ctx, cfg, pool)
    out["control"] = reference_steps(ctx, cfg, pool, precision="fp8")
    return {**{name: compare(got, want) for name, got in out.items()},
            "widest_leaves": {name: worst_leaves(got, want)
                              for name, got in out.items()}}


def run(ctx) -> harness.Outcome:
    cfg = model_config(ctx)
    batch = ctx.traffic["batch"]
    frames = batch * cfg["sequence_length"]
    watch = harness.Stopwatch(ctx.t_start)
    pool = generator.generate(ctx.traffic, sizes(cfg), ctx.seed, ctx.device)
    watch.mark("imports and traffic")
    prog = Program(ctx, cfg, pool, watch=watch)
    got = prog.checked_steps(cfg)
    watch.mark("checked steps")
    for _ in range(ctx.cell["setup_steps"] - CHECKED_STEPS):
        prog.step()
    cuda = torch.device(ctx.device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(ctx.device)
    watch.mark("warm-up steps")
    setup_s = time.perf_counter() - ctx.t_start

    waits, failed = [], 0
    t0 = time.perf_counter()
    while True:
        wait, skipped = prog.step()
        waits.append(wait)
        failed += skipped
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    if cuda:
        torch.cuda.synchronize(ctx.device)
    window_s = time.perf_counter() - t0
    steps = len(waits)

    traced = None
    if ctx.trace and cuda:
        def run_units(n):
            for _ in range(n):
                prog.step()
        traced = trace.profiled(run_units, ctx.cell["trace_units"],
                                ctx.device)
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    watch.report()
    prog.feed.close()
    del prog
    harness.free_card()

    want = reference_steps(ctx, cfg, pool, record=ctx.trace)
    values = compare(got, want)
    peak_name = ctx.config["peak_precision"]
    readings = harness.Readings(
        units=steps, window_s=window_s,
        spans={"input_wait": waits}, trace=traced,
        bounds=work.bound_by_kernel(want["log"], CHECKED_STEPS),
        kernel_names=work.names_by_kernel(want["log"]),
        flops_per_unit=want["flops"],
        peak_flops_per_s=work.PEAK_FLOPS_PER_S[peak_name])
    return harness.Outcome(
        attempted=steps, failed=failed,
        metrics={ctx.cell["rate_metric"]: (steps - failed) * frames
                 / window_s,
                 "setup_s": setup_s},
        checks=harness.judge(values, ctx.limits()),
        memory_peak_bytes=peak, readings=readings)
