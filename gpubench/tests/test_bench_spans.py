"""The readers of the port's spans (``metrics/prefetch_ms.py``,
``finite_wait_ms.py``, ``issue_ms.py``) on made-up span tables: ms a traced
unit, and nothing where there is no trace, no such span or no span module
in the program."""

from __future__ import annotations

import sys

import pytest

from gpubench import harness
from gpubench.harness import Readings

STEP = {"input#to_device": (4, 0.060), "geonet#step": (4, 0.500),
        "geonet#finite_sync": (4, 0.100), "kernel#K1": (12, 0.004)}
FRAME = {"uniad#frame": (3, 1.200), "uniad#decoder": (3, 0.150)}


@pytest.fixture
def spans(monkeypatch):
    from sndepth_tpu_torch.utils import tracing

    def use(table):
        monkeypatch.setattr(tracing, "snapshot", lambda: dict(table))
    return use


def traced(units: int) -> Readings:
    return Readings(units=100, window_s=10.0, trace={"units": units})


@pytest.mark.parametrize("metric, table, want", [
    ("prefetch_ms.flow", STEP, 15.0),
    ("finite_wait_ms.rigid", STEP, 25.0),
    ("issue_ms.flow", STEP, 100.0),
    ("issue_ms.serve", FRAME, 400.0),
    ("prefetch_ms.rigid", FRAME, None),
    ("finite_wait_ms.flow", FRAME, None),
    ("issue_ms.serve", {"kernel#K1": (1, 0.1)}, None)])
def test_span_readers(spans, metric, table, want):
    spans(table)
    reader = harness.metric_reader(metric)
    units = 3 if table is FRAME else 4
    got = reader.read(traced(units))
    assert got == (None if want is None else pytest.approx(want))
    assert reader.read(Readings(units=100, window_s=10.0)) is None


@pytest.mark.parametrize("metric", ["prefetch_ms.flow", "finite_wait_ms.flow",
                                    "issue_ms.serve"])
def test_a_program_without_spans_gives_nothing(monkeypatch, metric):
    monkeypatch.setitem(sys.modules, "sndepth_tpu_torch.utils.tracing", None)
    assert harness.metric_reader(metric).read(traced(4)) is None
