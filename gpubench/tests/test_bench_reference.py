"""The plain references against the port at tiny sizes on the CPU (the
port's CPU path, float32): GeoNet's first three train steps in both
stages, and UniAD's frames chained from the fresh state."""

from __future__ import annotations

import pytest
import torch

from gpubench import generator
from gpubench.tests.conftest import driver


@pytest.mark.parametrize("cell", ["geonet_flow_b32", "geonet_rigid_b128"])
def test_geonet_steps_match_reference(tiny, cell):
    ctx = tiny(cell)
    d = driver(cell)
    cfg = d.model_config(ctx)
    pool = generator.generate(ctx.traffic, d.sizes(cfg), ctx.seed,
                              ctx.device)
    prog = d.Program(ctx, cfg, pool)
    got = prog.checked_steps(cfg)
    want = d.reference_steps(ctx, cfg, pool)
    gaps = d.compare(got, want)
    # Float32 on both sides, two summation orders: the losses agree to
    # 1e-5, each leaf's first gradient to 1e-3 of its norm and its change
    # after three Adam steps to 2e-2 (Adam divides by the root of tiny
    # second moments, which magnifies rounding).
    assert gaps["loss"] < 1e-5, gaps
    assert gaps["grad"] < 1e-3, gaps
    assert gaps["update"] < 2e-2, gaps
    assert len(want["losses"]) == 3 and min(want["losses"]) > 0


def test_geonet_reference_chunks_rows():
    """Stage 1's reference may take a batch in chunks of rows: the same
    loss and gradients as in one piece."""
    from gpubench import harness, weights
    from gpubench.tests.conftest import tiny_config, tiny_traffic
    config = tiny_config("geonet_kitti_128x416")
    cfg = {**config["model"], "train_flow": False}
    ref = harness.load_module("reference", config["name"], "reference")
    d = driver("geonet_rigid_b128")
    state = weights.draw(d.weight_rules(ref, cfg), 5, "cpu")
    mix = {**tiny_traffic("kitti_snippets_b128"), "batch": 4}
    batch = generator.generate(mix, d.sizes(cfg), 5, "cpu")[0]
    whole = ref.ReferenceTrainer(cfg, state, "cpu").step(batch)
    parts = ref.ReferenceTrainer(cfg, state, "cpu", chunk=2).step(batch)
    assert parts[0] == pytest.approx(whole[0], rel=1e-6)
    for k, g in whole[1].items():
        torch.testing.assert_close(parts[1][k], g, rtol=1e-4, atol=1e-9)


def test_uniad_frames_match_reference(tiny):
    ctx = tiny("uniad_track_6cam")
    d = driver("uniad_track_6cam")
    gaps = d.readings(ctx)["program"]
    # The port in float32 against the reference in float64: the BEV and
    # the track tensors agree to 1e-5 of their RMS, the served boxes and
    # scores to 1e-4 (metres, radians, metres a second), every decision.
    assert gaps["decisions"] == 0, gaps
    for k in ("bev", "tracks"):
        assert gaps[k] < 1e-5, gaps
    assert gaps["dets"] < 1e-4, gaps


@pytest.mark.parametrize("cell, kernels", [
    ("geonet_flow_b32", {"K1", "K2", "K3", "K4", "K5", "K5b", "K6", "K7"}),
    ("geonet_rigid_b128", {"K1", "K2"}),
    ("uniad_track_6cam", {"K5"})])
def test_traced_run_counts_work(tiny, cell, kernels):
    """With ``--trace 1`` the reference's first step or frame gives its
    FLOPs and its notes the hand-written kernels' bounds (the trace itself
    needs a card)."""
    out = driver(cell).run(tiny(cell, trace=True))
    assert set(out.readings.bounds) == kernels
    assert all(v > 0 for v in out.readings.bounds.values())
    assert out.readings.flops_per_unit > 0


@pytest.mark.parametrize("size", ["tiny", "published"])
def test_uniad_weight_table_matches_port(size):
    """The reference's table of weights, written out from the published
    architecture, names every key of the port's state dict with its shape,
    in the port's order, and nothing more."""
    from gpubench import harness
    from gpubench.tests.conftest import _LOAD_CONFIG, tiny_config
    from sndepth_tpu_torch.models import uniad_track
    cfg = (tiny_config if size == "tiny" else _LOAD_CONFIG)(
        "uniad_base_track")
    ref = harness.load_module("reference", cfg["name"], "reference")
    with torch.device("meta"):
        port = uniad_track.UniADTrack(**cfg["model"])
    want = [(k, tuple(v.shape)) for k, v in port.state_dict().items()]
    got = [(k, tuple(shape)) for k, shape, _ in
           ref.weight_rules(cfg["model"])]
    assert got == want
