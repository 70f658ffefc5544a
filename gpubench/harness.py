"""What every cell shares: finding configurations, cells, drivers, metric
readers and references by name; the names' rules; seeds; the result line.

A configuration is ``configs/<name>.json``, a cell ``workloads/<name>.json``
(its configuration, its traffic parameters, the driver that runs it, the
limits of its correctness check), a traffic mix ``traffic/<name>.json``
whose ``kind`` is a generator ``traffic_kinds/<kind>.py`` (a
``generate(params, seed, device)``), a driver ``drivers/<name>.py`` (a
``run(ctx)`` that returns a :class:`Outcome`), a per-layer metric
``metrics/<name>.py`` or the file of its quantity (:func:`metric_reader`: a
``read(readings)`` that returns a number or ``None``) and a plain reference
``reference/<config>.py``. Nothing here names a cell: a new one is new
files and new entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK_FILE = os.path.join(ROOT, "BENCHMARK.json")

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# Top-level module names that no process of the benchmark may hold: the JAX
# stack and the JAX package the port was written from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "sndepth_tpu")


class BenchError(RuntimeError):
    """A cell, configuration or file that breaks the benchmark's rules."""


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise BenchError(f"{what} {name!r} breaks the name rule "
                         f"{NAME_RE.pattern}")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise BenchError(f"unit {unit!r} breaks the rule {UNIT_RE.pattern}")
    return unit


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _file(folder: str, name: str, ext: str, what: str) -> str:
    check_name(name, what)
    path = os.path.join(HERE, folder, name + ext)
    if not os.path.isfile(path):
        raise BenchError(f"no {what} {name!r}: {path} is missing")
    return path


def load_benchmark() -> dict:
    bench = _read_json(BENCHMARK_FILE)
    for m in bench["end_to_end"] + bench["per_layer"]:
        check_name(m["name"], "metric")
        check_unit(m["unit"])
        if m["better"] not in ("lower", "higher"):
            raise BenchError(f"metric {m['name']}: better is {m['better']!r}")
    for w in bench["workloads"]:
        check_name(w["name"], "cell")
    return bench


def load_config(name: str) -> dict:
    cfg = _read_json(_file("configs", name, ".json", "configuration"))
    if cfg.get("name") != name:
        raise BenchError(f"configs/{name}.json names itself "
                         f"{cfg.get('name')!r}")
    for key in cfg.get("reduced", []):
        check_name(key, "reduced key")
    return cfg


def load_workload(name: str) -> dict:
    """The cell's file, checked against its configuration and driver."""
    cell = _read_json(_file("workloads", name, ".json", "cell"))
    if cell.get("name") != name:
        raise BenchError(f"workloads/{name}.json names itself "
                         f"{cell.get('name')!r}")
    for key in ("config", "traffic", "driver"):
        check_name(cell.get(key), f"{name}'s {key}")
    if cell.get("chips") not in (1, 4):
        raise BenchError(f"cell {name}: chips must be 1 or 4")
    load_config(cell["config"])
    load_traffic(cell["traffic"])
    _file("drivers", cell["driver"], ".py", "driver")
    for check, limit in cell.get("limits", {}).items():
        check_name(check, f"{name}'s check")
        if not isinstance(limit, (int, float)) or limit < 0:
            raise BenchError(f"cell {name}: limit of {check} is {limit!r}")
    return cell


def load_traffic(name: str) -> dict:
    mix = _read_json(_file("traffic", name, ".json", "traffic mix"))
    _file("traffic_kinds", mix.get("kind"), ".py", f"traffic {name}'s kind")
    return mix


def load_module(folder: str, name: str, what: str):
    """Import ``<folder>/<name>.py`` by path (a metric's name may hold dots,
    which an import by name would read as packages)."""
    path = _file(folder, name, ".py", what)
    mod_name = "gpubench._loaded." + folder + "." + re.sub(r"\W", "_", name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """A per-layer metric's reader: ``metrics/<name>.py``, else the reader
    of the quantity its name holds before its last dot (``metrics/
    launches_per_step.py`` reads ``launches_per_step.flow`` and
    ``launches_per_step.rigid``, each moving its own cells' rate)."""
    check_name(name, "metric")
    stem = name.rpartition(".")[0]
    if (not os.path.isfile(os.path.join(HERE, "metrics", name + ".py"))
            and stem):
        return load_module("metrics", stem, "metric reader")
    return load_module("metrics", name, "metric reader")


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"BENCHMARK.json has no cell {name!r}")


def end_to_end_for(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics a cell reports."""
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_for(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    that list no cell where the cell reports the metric they move."""
    own = {m["name"] for m in end_to_end_for(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in own
                             else [])]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (weights, traffic, a sample) of the run's
    ``--seed``, which may be any whole number."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def forbidden_modules() -> list[str]:
    """Modules held by this process whose top-level name, compared whole,
    is one of :data:`FORBIDDEN_MODULES`."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


@dataclasses.dataclass
class Readings:
    """What a run leaves for the per-layer readers. Times in seconds."""
    units: int = 0                       # steps or frames in the window
    window_s: float = 0.0                # the window's host time
    spans: dict = dataclasses.field(default_factory=dict)  # name -> [s]
    trace: dict | None = None            # gpubench.trace.reduce's summary
    bounds: dict = dataclasses.field(default_factory=dict)  # kernel -> s/unit
    kernel_names: dict = dataclasses.field(default_factory=dict)  # -> names
    flops_per_unit: float | None = None
    peak_flops_per_s: float | None = None


@dataclasses.dataclass
class Outcome:
    """A driver's report of one run."""
    attempted: int
    failed: int
    metrics: dict                        # end-to-end name -> value
    checks: dict                         # check name -> (value, limit)
    memory_peak_bytes: int
    readings: Readings


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its configuration and traffic mix, the
    run's flags, the device and the process's start on the host clock."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float

    def limits(self) -> dict:
        return self.cell.get("limits", {})

    def reference(self):
        """The configuration's plain reference module."""
        return load_module("reference", self.config["name"], "reference")


def free_card() -> None:
    """Give the card's cached memory back once a side's state is gone."""
    import gc

    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Stopwatch:
    """Seconds of each stage of set-up since the process started, printed
    on standard error for the record."""

    def __init__(self, t_start: float):
        import time
        self.clock, self.last, self.stages = time.perf_counter, t_start, []

    def mark(self, stage: str) -> None:
        now = self.clock()
        self.stages.append((stage, now - self.last))
        self.last = now

    def report(self) -> None:
        print("setup stages: " + ", ".join(f"{s} {t:.2f} s"
                                           for s, t in self.stages),
              file=sys.stderr, flush=True)


def judge(values: dict, limits: dict) -> dict:
    """Each number the cell's limits name beside its limit:
    ``{name: (value, limit)}``; one the run did not produce reads ``nan``
    and fails, as does one that is not finite. Other readings are printed
    on standard error for the record, not compared."""
    for name in sorted(set(values) - set(limits)):
        print(f"recorded {name} {float(values[name])!r} (not compared)",
              file=sys.stderr)
    return {name: (float(values.get(name, float("nan"))), float(limit))
            for name, limit in limits.items()}


def all_within(checks: dict) -> bool:
    import math
    return bool(checks) and all(
        limit is not None and math.isfinite(value) and value <= limit
        for value, limit in checks.values())


def emit(result: dict, checks: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output, ``checks`` its last key."""
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, (value, limit) in checks.items()}
    print(json.dumps(result), flush=True)
