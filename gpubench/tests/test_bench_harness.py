"""The harness on the CPU: files found by name, the contract's rules on
BENCHMARK.json and on names and units, the result line's keys, and no
fallback to the CPU without a card."""

from __future__ import annotations

import io
import json
import os
import shutil
from contextlib import redirect_stdout

import pytest
import torch

from gpubench import harness, run
from gpubench.tests.conftest import tiny_config, tiny_traffic

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_and_matches(cell):
    entry = harness.cell_entry(BENCH, cell)
    spec = harness.load_workload(cell)
    for key in ("config", "traffic", "chips"):
        assert entry[key] == spec[key]
    assert harness.load_module("drivers", spec["driver"], "driver").run
    harness.load_module("reference", spec["config"], "reference")
    own = harness.end_to_end_for(BENCH, cell)
    names = {m["name"] for m in own}
    assert "setup_s" in names and len(names) >= 2
    layer = harness.per_layer_for(BENCH, cell)
    assert layer, "every cell reports a per-layer metric"
    for m in layer:
        assert m["moves"] in names, (m["name"], cell)


def test_configs_files_and_sources():
    files = set()
    for c in BENCH["configs"]:
        cfg = harness.load_config(c["name"])
        assert c["file"] == f"gpubench/configs/{c['name']}.json"
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        files.add(c["file"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len(files) == len(BENCH["configs"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_and_silent_without_data(metric):
    reader = harness.metric_reader(metric)
    assert reader.read(harness.Readings()) is None


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 24
    budget = ((2 + 14 * cells) * (BENCH["run_seconds"] + 60)
              + cells * 2 * 90 + 1200)
    assert budget <= 43200
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in E2E
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    with open(harness.BENCHMARK_FILE, "rb") as f:
        assert len(f.read()) <= 64 * 1024


@pytest.mark.parametrize("name, ok", [
    ("train_frames_per_s", True), ("input_wait_ms.train", True),
    ("_x-1.2", True), ("a" * 64, True), ("a" * 65, False),
    ("has space", False), ("a/b", False), ("a,b", False), ("μs", False),
    (".lead", False)])
def test_name_rule(name, ok):
    if ok:
        assert harness.check_name(name, "metric") == name
    else:
        with pytest.raises(harness.BenchError):
            harness.check_name(name, "metric")


@pytest.mark.parametrize("unit, ok", [
    ("frames/s", True), ("%", True), ("ms", True), ("launches", True),
    ("tokens per second", False), ("μs", False), ("", False),
    ("x" * 17, False)])
def test_unit_rule(unit, ok):
    if ok:
        assert harness.check_unit(unit) == unit
    else:
        with pytest.raises(harness.BenchError):
            harness.check_unit(unit)


def test_new_cell_file_is_found_without_code(tmp_path, monkeypatch):
    """A copy of the benchmark's data folders with one more cell file: the
    harness finds and checks it, and BENCHMARK.json's metrics reach it."""
    for folder in ("configs", "workloads", "traffic", "traffic_kinds",
                   "drivers", "metrics", "reference"):
        shutil.copytree(os.path.join(harness.HERE, folder),
                        tmp_path / folder)
    cell = harness.load_workload("geonet_flow_b32")
    cell.update(name="geonet_flow_b8", traffic="kitti_snippets_b8")
    (tmp_path / "workloads" / "geonet_flow_b8.json").write_text(
        json.dumps(cell))
    (tmp_path / "traffic" / "kitti_snippets_b8.json").write_text(
        json.dumps({"kind": "snippets", "pool": 4, "batch": 8}))
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    assert harness.load_workload("geonet_flow_b8")["traffic"] == (
        "kitti_snippets_b8")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "geonet_flow_b8",
                               "config": cell["config"],
                               "traffic": "kitti_snippets_b8", "chips": 1,
                               "why": "a smaller batch"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "geonet_flow_b32" in m.get("workloads", []):
            m["workloads"].append("geonet_flow_b8")
    assert {m["name"] for m in harness.per_layer_for(bench,
                                                      "geonet_flow_b8")} == {
        m["name"] for m in harness.per_layer_for(bench, "geonet_flow_b32")}
    with pytest.raises(harness.BenchError):
        harness.load_workload("no_such_cell")


def test_new_traffic_kind_is_found_without_code(tmp_path, monkeypatch):
    """A traffic kind is a file: a mix of a new kind is found, checked and
    generated with no code changed; a mix of a kind with no file is
    refused."""
    for folder in ("traffic", "traffic_kinds"):
        shutil.copytree(os.path.join(harness.HERE, folder),
                        tmp_path / folder)
    (tmp_path / "traffic_kinds" / "ramp.py").write_text(
        "import torch\n\n\ndef generate(p, seed, device):\n"
        "    return torch.arange(p['n'], device=device) * p['step']\n")
    (tmp_path / "traffic" / "ramp_4.json").write_text(
        json.dumps({"kind": "ramp", "n": 4, "why": "a ramp"}))
    (tmp_path / "traffic" / "nothing.json").write_text(
        json.dumps({"kind": "no_such_kind"}))
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    mix = harness.load_traffic("ramp_4")
    from gpubench import generator
    assert generator.generate(mix, {"step": 2}, 1, "cpu").tolist() == [
        0, 2, 4, 6]
    with pytest.raises(harness.BenchError):
        harness.load_traffic("nothing")


def test_bad_cell_file_is_refused(tmp_path, monkeypatch):
    for folder in ("configs", "workloads", "traffic", "traffic_kinds",
                   "drivers"):
        shutil.copytree(os.path.join(harness.HERE, folder),
                        tmp_path / folder)
    cell = harness.load_workload("geonet_flow_b32")
    cell.update(name="bad_cell", chips=2)
    (tmp_path / "workloads" / "bad_cell.json").write_text(json.dumps(cell))
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    with pytest.raises(harness.BenchError):
        harness.load_workload("bad_cell")


def test_no_card_no_result(capsys):
    """Without a card the run prints no result and exits with a code other
    than 0; it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "geonet_flow_b32", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == run.NO_CARD
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run (past the look for a card) exits with a code other than
    0 and prints no result: the program under test is not there."""
    import subprocess
    import sys
    shutil.copy(harness.BENCHMARK_FILE, tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; from gpubench import run; sys.exit(run.main("
            "['--workload', 'geonet_flow_b32', '--seed', '7', '--seconds', "
            "'1', '--trace', '0'], device=torch.device('cpu')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env={**os.environ, "PYTHONPATH": str(tmp_path)},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "sndepth_tpu_torch" in proc.stderr


def _result(monkeypatch, args):
    monkeypatch.setattr(harness, "load_config", tiny_config)
    monkeypatch.setattr(harness, "load_traffic", tiny_traffic)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(args, device=torch.device("cpu"))
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_result_line_keys(monkeypatch):
    """The last line holds exactly correct, attempted, failed, metrics and
    device, then the compared numbers beside their limits, last."""
    line = _result(monkeypatch, ["--workload", "uniad_track_6cam", "--seed",
                                 str(2 ** 32 + 5), "--seconds", "0.5",
                                 "--trace", "0"])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {
        m["name"] for m in harness.end_to_end_for(BENCH, "uniad_track_6cam")}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert not harness.forbidden_modules()


def test_forbidden_module_refuses_result(monkeypatch, capsys):
    monkeypatch.setattr(harness, "load_config", tiny_config)
    monkeypatch.setattr(harness, "load_traffic", tiny_traffic)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: ["jax"])
    rc = run.main(["--workload", "uniad_track_6cam", "--seed", "3",
                   "--seconds", "0.2", "--trace", "0"],
                  device=torch.device("cpu"))
    assert rc == run.FORBIDDEN
    out = capsys.readouterr()
    assert "{" not in out.out and "jax" in out.err


def test_metric_reader_by_name_or_quantity(tmp_path, monkeypatch):
    """A per-layer metric is read by ``metrics/<name>.py`` where that file
    is there, else by its quantity's reader (its name before the last
    dot); a name that finds neither is refused."""
    shutil.copytree(os.path.join(harness.HERE, "metrics"),
                    tmp_path / "metrics")
    (tmp_path / "metrics" / "launches_per_step.odd.py").write_text(
        "def read(r):\n    return 7.0\n")
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    from gpubench.harness import Readings
    r = Readings(units=1, window_s=1.0, trace={"units": 2, "launches": 10})
    assert harness.metric_reader("launches_per_step.flow").read(r) == 5
    assert harness.metric_reader("launches_per_step.odd").read(r) == 7.0
    for m in BENCH["per_layer"]:
        harness.metric_reader(m["name"])
    with pytest.raises(harness.BenchError):
        harness.metric_reader("no_such_quantity.flow")
