"""UniAD tracking cell: the port's ``models.uniad_track.UniADTrack.forward``
on a six-camera clip, one frame at a time in a closed loop (each frame sent
when the last has come back), its ``TrackState`` carried from frame to
frame.

Set-up draws the weights (the benchmark's own, on the device), builds the
port's model, sets the configuration's precision and runs the first
``setup_frames`` frames: frame 0 from the fresh state (the start, checked),
the next with the ego shift and rotation (the shifted previous BEV). The
window then runs frames for ``--seconds``: the clip's frames cycled,
timestamps ``dt_s`` apart, the seeded ego motion of each. A frame's latency
is taken from its call until its detections are on the host's side of a
synchronisation (a finite-check of the detections); a frame with non-finite
detections counts as failed.

After the window the port's model is freed and the plain reference
(``reference/<config>.py``, in float64) recomputes frame 0 from its own
fresh state, and, from the port's own state before each, the frames of a
sample drawn from the seed among those the window finished (the last
always in it): the reference cannot follow 100 frames in the time of a
run, so it follows the port frame by frame, and frame 0 checks the start
that this skips.
"""

from __future__ import annotations

import math
import random
import statistics
import time

import torch

from gpubench import generator, harness, trace, weights, work

# Scores this close to a threshold of the tracker may land on either side
# between two correct float32 evaluations: their decisions are not counted.
DECISION_MARGIN = 1e-3
TRACK_FIELDS = ("ref_pts", "output_embedding", "track_scores",
                "pred_logits", "pred_boxes", "mem_bank")


def draw_weights(ctx) -> dict:
    """The benchmark's weights: every key of the reference's table, drawn
    on the device from the seed."""
    return weights.draw(ctx.reference().weight_rules(ctx.config["model"]),
                        ctx.seed, ctx.device)


def build_reference(ctx, dtype=torch.float64):
    """The plain reference with the same weights, in ``dtype``: float64
    judges (it holds both the port's float32 and the control's rounding
    apart from the truth), float32 under TF32 is the control."""
    weights_ = {k: v.to(dtype) for k, v in draw_weights(ctx).items()}
    return ctx.reference().build(ctx.config["model"], weights_)


def set_precision(ctx, tf32: bool | None = None) -> None:
    """The configuration's precision, a process-wide deployment setting:
    float32 with TF32 off (``tf32`` overrides it for the control)."""
    on = ctx.config["tf32"] if tf32 is None else tf32
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def build_program(ctx):
    """The port's model on the device with the benchmark's weights."""
    from sndepth_tpu_torch.models import uniad_track
    with torch.device(ctx.device):
        model = uniad_track.UniADTrack(**ctx.config["model"])
    model.load_state_dict(draw_weights(ctx), strict=True)
    return model.eval()


def clip_inputs(ctx) -> dict:
    img = ctx.config["image"]
    return generator.generate(
        ctx.traffic, {"cams": ctx.config["model"]["num_cams"],
                      "height": img["height"], "width": img["width"]},
        ctx.seed, ctx.device)


def frame_args(clip: dict, i: int, state) -> dict:
    """Frame ``i`` of the run: the clip's frame i mod F, ``dt_s`` after the
    state's timestamp, with the ego motion of that frame after the first."""
    k = i % clip["images"].shape[0]
    return {"images": clip["images"][k], "lidar2img": clip["lidar2img"],
            "timestamp": state.timestamp + clip["dt_s"],
            "ego_shift": None if i == 0 else clip["ego_shift"][k],
            "ego_rotation_deg": None if i == 0 else
            clip["ego_rotation_deg"][k]}


def call(model, args: dict, state):
    with torch.no_grad():
        return model(args["images"], args["lidar2img"], state,
                     timestamp=args["timestamp"], ego_shift=args["ego_shift"],
                     ego_rotation_deg=args["ego_rotation_deg"])


def finite(results: dict) -> bool:
    return bool(torch.isfinite(results["bboxes"]).all()
                & torch.isfinite(results["scores"]).all())


def _rms(t: torch.Tensor) -> float:
    return float(t.detach().double().pow(2).mean().sqrt())


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest element gap over the reference's root mean square."""
    if got.shape != want.shape:
        return float("nan")
    d = float((got.detach().double() - want.detach().double()).abs().max())
    return d / max(_rms(want), 1e-30)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The root mean square of the gap over the reference's."""
    if got.shape != want.shape:
        return float("nan")
    return _rms(got.double() - want.double()) / max(_rms(want), 1e-30)


def _boxes_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The served boxes' RMS gap over the reference's RMS, their nine
    parameters together (the yaw's gap taken round the circle)."""
    if got.shape != want.shape:
        return float("nan")
    d = got.double() - want.double()
    d[:, 6] = torch.remainder(d[:, 6] + math.pi, 2 * math.pi) - math.pi
    return _rms(d) / max(_rms(want), 1e-30)


def _box_gaps(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The widest gaps between two sets of boxes (cx, cy, cz, w, l, h, yaw,
    vx, vy): of a centre (metres), of a size's logarithm, of a yaw (radians,
    round the circle) and of a velocity (metres a second)."""
    if got.shape != want.shape:
        return dict.fromkeys(("centre", "log_size", "yaw", "velocity"),
                             float("nan"))
    g, w = got.double(), want.double()
    yaw = torch.remainder(g[:, 6] - w[:, 6] + math.pi, 2 * math.pi) - math.pi
    return {"centre": float((g[:, :3] - w[:, :3]).norm(dim=-1).max()),
            "log_size": float((g[:, 3:6].log() - w[:, 3:6].log()).abs().max()),
            "yaw": float(yaw.abs().max()),
            "velocity": float((g[:, 7:9] - w[:, 7:9]).abs().max())}


def compare(ctx, got_state, got_res, want_state, want_res) -> dict:
    """The check's numbers for one frame: the BEV handed on (the widest
    element gap over the reference's RMS), the carried track tensors (the
    worst tensor's RMS gap over the reference's), and the tracker's
    decisions, served ones included (an exact count, slots within
    DECISION_MARGIN of a threshold left out). The served boxes are recorded
    (their RMS gap over the reference's, ``dets``, and the widest gaps of
    scores, centres, sizes, yaws and velocities), not compared: a few
    decoder slots of the seeded model move by metres with the float32
    rounding of either side, and the TF32 control moves the served boxes
    no more than that on some seeds, so no limit holds the two apart."""
    m = ctx.config["model"]
    gt, wt = got_state.tracks, want_state.tracks
    ws = wt.track_scores
    near = torch.zeros_like(ws, dtype=torch.bool)
    for thresh in (m["score_thresh"], m["filter_score_thresh"]):
        near |= (ws - thresh).abs() < DECISION_MARGIN
    differs = ((gt.obj_idxes >= 0) != (wt.obj_idxes >= 0)) | (
        gt.disappear_time != wt.disappear_time) | (
        gt.save_period != wt.save_period) | (
        gt.mem_valid != wt.mem_valid).any(-1)
    decisions = int((differs & ~near).sum())
    if not bool((differs & near).any()):
        decisions += int((gt.obj_idxes != wt.obj_idxes).sum())
        decisions += int(got_state.next_obj_id != want_state.next_obj_id)
    fields = TRACK_FIELDS + (() if bool(differs.any()) else ("query",))
    tracks = max(_rel(getattr(gt, f), getattr(wt, f)) for f in fields)

    # Each served detection against the reference's slot it names: the
    # slots served have to be among the reference's best by track score,
    # and each has to carry the track ID the reference gives that slot.
    q = got_res["query_idx"]
    k = q.shape[0]
    kth = torch.sort(ws, descending=True).values[k - 1]
    decisions += int((ws[q] < kth - DECISION_MARGIN).sum())
    decisions += int(((got_res["obj_idxes"] != wt.obj_idxes[q])
                      & ~near[q]).sum())
    want_boxes = ctx.reference().denormalize_bbox(wt.pred_boxes[q])
    boxes = _box_gaps(got_res["bboxes"], want_boxes)
    boxes["centre_m"] = boxes.pop("centre")
    return {"bev": _gap(got_state.prev_bev, want_state.prev_bev),
            "tracks": tracks, "dets": _boxes_rel(got_res["bboxes"],
                                                 want_boxes),
            "decisions": float(decisions),
            "scores": float((got_res["scores"].double() - ws[q].double())
                            .abs().max()),
            **{f"box_{k}": v for k, v in boxes.items()}}


def worst(per_frame: list) -> dict:
    """Each number's worst frame; a number that is not a number in any
    frame stays so."""
    out = {}
    for d in per_frame:
        for k, v in d.items():
            old = out.get(k, 0.0)
            out[k] = v if (math.isnan(v) or math.isnan(old)) else max(old, v)
    return out



def reference_frames(ctx, clip: dict, start, kept: list,
                     record: bool = False):
    """The float64 reference's frame 0 from its own fresh state against
    the port's (``start`` = (state, results)), and each kept frame (i,
    state before, state after, results) from the port's state before it.
    Returns (the check's numbers, each its worst frame; the work log a
    frame; FLOPs a frame)."""
    from torch.utils.flop_counter import FlopCounterMode
    ref = ctx.reference()
    set_precision(ctx, False)
    model = build_reference(ctx)
    per_frame, log, flops = [], [], None
    fresh = model.init_state()
    args = frame_args(clip, 0, fresh)
    if record:
        counter = FlopCounterMode(display=False)
        with work.recording() as log, counter:
            state, res = ref.frame(model, state=fresh, **args)
        flops = float(counter.get_total_flops())
    else:
        state, res = ref.frame(model, state=fresh, **args)
    # The start's decoder outputs are recorded, not compared: from the
    # fresh queries a few decoder slots swing with the float32 rounding of
    # either side (the port's and a float32 reference's alike) by up to a
    # fifth of the TF32 control's gap on some seeds; the start's BEV and
    # decisions are compared, and the window frames' track tensors.
    first = compare(ctx, start[0], start[1], state, res)
    for key in ("tracks", "dets"):
        first[f"{key}_start"] = first.pop(key)
    per_frame.append(first)
    for i, before, after, results in kept:
        args = frame_args(clip, i, before)
        state, res = ref.frame(model, state=ref.state_from(
            before, model.dtype), **args)
        per_frame.append(compare(ctx, after, results, state, res))
    set_precision(ctx)
    return worst(per_frame), log, flops


def run(ctx) -> harness.Outcome:
    watch = harness.Stopwatch(ctx.t_start)
    set_precision(ctx)
    clip = clip_inputs(ctx)
    watch.mark("imports and traffic")
    model = build_program(ctx)
    watch.mark("weights and model")
    state = model.init_state()
    start = call(model, frame_args(clip, 0, state), state)
    finite(start[1])
    watch.mark("frame 0")
    state = start[0]
    for i in range(1, ctx.cell["setup_frames"]):
        state, results = call(model, frame_args(clip, i, state), state)
        finite(results)
    cuda = torch.device(ctx.device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(ctx.device)
    watch.mark("warm-up frames")
    setup_s = time.perf_counter() - ctx.t_start

    sampler = random.Random(harness.sub_seed(ctx.seed, "frame_sample"))
    size = ctx.cell["sample_frames"]
    kept, latencies, failed = [], [], 0
    i = ctx.cell["setup_frames"]
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        args = frame_args(clip, i, state)
        new_state, results = call(model, args, state)
        ok = finite(results)
        latencies.append(time.perf_counter() - t)
        failed += not ok
        n = len(latencies)
        entry = (i, state, new_state, results)
        if n <= size:
            kept.append(entry)
        elif sampler.random() < size / n:
            kept[sampler.randrange(size)] = entry
        state = new_state
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    if all(e[0] != entry[0] for e in kept):
        kept.append(entry)

    traced = None
    if ctx.trace and cuda:
        carry = {"state": state, "i": i}

        def run_units(n):
            for _ in range(n):
                s = carry["state"]
                carry["state"], res = call(
                    model, frame_args(clip, carry["i"], s), s)
                finite(res)
                carry["i"] += 1
        traced = trace.profiled(run_units, ctx.cell["trace_units"],
                                ctx.device)
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    watch.report()
    del model, state, new_state, results
    harness.free_card()

    values, log, flops = reference_frames(ctx, clip, start, kept,
                                          record=ctx.trace)
    frames = len(latencies)
    readings = harness.Readings(
        units=frames, window_s=window_s, trace=traced,
        bounds=work.bound_by_kernel(log, 1),
        kernel_names=work.names_by_kernel(log), flops_per_unit=flops,
        peak_flops_per_s=work.PEAK_FLOPS_PER_S[ctx.config["peak_precision"]])
    p90 = statistics.quantiles(latencies, n=10, method="inclusive")[8]
    print(f"frames {frames} in {window_s:.3f} s; p90 over {frames} "
          f"latencies, {sum(x > p90 for x in latencies)} above it",
          flush=True)
    return harness.Outcome(
        attempted=frames, failed=failed,
        metrics={"serve_frames_per_s": (frames - failed) / window_s,
                 "frame_ms_p90": p90 * 1e3, "setup_s": setup_s},
        checks=harness.judge(values, ctx.limits()),
        memory_peak_bytes=peak, readings=readings)


def answer_altered(forward):
    """A fault: each frame's first served detection reports a track ID
    that is not its own."""
    def broken(self, *args, **kwargs):
        state, results = forward(self, *args, **kwargs)
        ids = results["obj_idxes"].clone()
        ids[0] += 1
        return state, {**results, "obj_idxes": ids}
    return broken


def state_unchanged(forward):
    """A fault: each frame hands on the state it was given."""
    def broken(self, images, lidar2img, state, *args, **kwargs):
        _, results = forward(self, images, lidar2img, state, *args, **kwargs)
        return state, results
    return broken


def readings(ctx) -> dict:
    """For setting the check's limits, at the cell's own size: the check's
    numbers of the port over a short chain of frames (frame 0 and the
    chain's frames, each followed from the port's state), and of the
    control, the reference with TF32 on in the port's place."""
    set_precision(ctx)
    clip = clip_inputs(ctx)
    frames = ctx.cell["setup_frames"] + ctx.cell["sample_frames"]
    model = build_program(ctx)
    state = model.init_state()
    start = call(model, frame_args(clip, 0, state), state)
    state, kept = start[0], []
    for i in range(1, frames):
        new_state, results = call(model, frame_args(clip, i, state), state)
        kept.append((i, state, new_state, results))
        state = new_state
    del model
    harness.free_card()
    out = {"program": reference_frames(ctx, clip, start, kept)[0]}
    # The control: the float32 reference under TF32 followed frame by
    # frame as the port is, judged by the float64 reference.
    ref = ctx.reference()
    set_precision(ctx, True)
    model = build_reference(ctx, torch.float32)
    state = model.init_state()
    c_start = ref.frame(model, state=state, **frame_args(clip, 0, state))
    state, c_kept = c_start[0], []
    for i in range(1, frames):
        new_state, results = ref.frame(model, state=state,
                                       **frame_args(clip, i, state))
        c_kept.append((i, state, new_state, results))
        state = new_state
    del model
    harness.free_card()
    out["control"] = reference_frames(ctx, clip, c_start, c_kept)[0]
    return out
