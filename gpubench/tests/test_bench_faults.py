"""The check fails what it must: each cell's run driven on the CPU past
the look for a card, with the timed path broken underneath, reads not
correct under the cell's own limits; and the control (the reference one
precision step below the configuration's, in the port's place) fails
them too."""

from __future__ import annotations

import pytest
import torch

from gpubench import harness
from gpubench.tests.conftest import driver


def _run(ctx, cell):
    return driver(cell).run(ctx)


def test_sound_run_is_correct(tiny):
    out = _run(tiny("geonet_flow_b32"), "geonet_flow_b32")
    assert harness.all_within(out.checks), out.checks
    assert out.attempted > 0 and out.failed == 0


def test_geonet_state_unchanged_fails(tiny, monkeypatch):
    """A step whose update never lands: the port's Adam does nothing."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    out = _run(tiny("geonet_rigid_b128"), "geonet_rigid_b128")
    assert not harness.all_within(out.checks), out.checks


@pytest.mark.parametrize("cell", ["geonet_flow_b32", "geonet_rigid_b128"])
def test_geonet_half_batch_fails(tiny, monkeypatch, cell):
    from sndepth_tpu_torch.train import geonet
    d = driver(cell)
    monkeypatch.setattr(geonet, "train_step",
                        d.half_batch_step(geonet.train_step))
    ctx = tiny(cell)
    ctx.traffic["batch"] = 4
    out = _run(ctx, cell)
    assert not harness.all_within(out.checks), out.checks


@pytest.mark.parametrize("fault", ["answer_altered", "state_unchanged"])
def test_uniad_faults_fail(tiny, monkeypatch, fault):
    from sndepth_tpu_torch.models import uniad_track
    d = driver("uniad_track_6cam")
    monkeypatch.setattr(uniad_track.UniADTrack, "forward",
                        getattr(d, fault)(uniad_track.UniADTrack.forward))
    out = _run(tiny("uniad_track_6cam"), "uniad_track_6cam")
    assert not harness.all_within(out.checks), out.checks


def test_geonet_control_fails(tiny):
    """The reference with float8 convolution operands in the port's place
    reads not correct under the stage-2 cell's limits."""
    from gpubench import generator
    ctx = tiny("geonet_flow_b32")
    d = driver("geonet_flow_b32")
    cfg = d.model_config(ctx)
    pool = generator.generate(ctx.traffic, d.sizes(cfg), ctx.seed,
                              ctx.device)
    want = d.reference_steps(ctx, cfg, pool)
    control = d.reference_steps(ctx, cfg, pool, precision="fp8")
    checks = harness.judge(d.compare(control, want), ctx.limits())
    assert not harness.all_within(checks), checks


@pytest.mark.card
def test_uniad_control_fails_on_card(card, tiny):
    """TF32 exists only on the card: the reference under TF32 in the
    port's place reads not correct under the cell's limits."""
    from gpubench.tests.conftest import _LOAD_CONFIG
    ctx = tiny("uniad_track_6cam")
    ctx.device = card
    # The published depth and widths, at 224x416 with a 50x50 BEV: TF32's
    # error grows through the 33 bottlenecks, which a tiny net lacks.
    ctx.config = _LOAD_CONFIG("uniad_base_track")
    ctx.config["model"].update(bev_h=50, bev_w=50)
    ctx.config["image"] = {"height": 224, "width": 416}
    readings = driver("uniad_track_6cam").readings(ctx)
    checks = harness.judge(readings["control"], ctx.limits())
    assert not harness.all_within(checks), checks
