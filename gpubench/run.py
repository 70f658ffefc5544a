"""Run one cell of the benchmark once and print its result line.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The cell's file (``workloads/<cell>.json``) names its configuration,
traffic mix and driver; the driver builds the port's entry from the seed,
runs it for ``--seconds`` after set-up, checks what it produced against the
plain reference and reports. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (each read by
``metrics/<name>.py`` or its quantity's reader) with the device's busy
time and a breakdown. The last line of standard output is one JSON
object; the numbers compared with the reference, each beside its limit,
are the last lines of standard error. Without a card, or with fewer than
the cell asks for, it prints no result and exits with 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

NO_CARD = 2
FORBIDDEN = 3
# The process's host threads for torch's CPU work (the input layer's copies
# into pinned memory): one, so that every run loads the host alike.
HOST_THREADS = 1


def _cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The port builds its CUDA sources into ``build/`` at the root by
    itself."""
    build = os.path.join(root, "build")
    for var, sub in (("TRITON_CACHE_DIR", "triton_cache"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(build, sub)
    # A library that could load JAX by itself is kept from it.
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = str(HOST_THREADS)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=(0, 1))
    return p.parse_args(argv)


def main(argv=None, device=None, t_start: float | None = None) -> int:
    """Run the cell; ``device`` set skips the look for cards (the CPU
    tests drive the rest of a run so)."""
    args = parse(argv)
    from gpubench import harness
    _cache_dirs(harness.ROOT)
    bench = harness.load_benchmark()
    entry = harness.cell_entry(bench, args.workload)
    cell = harness.load_workload(args.workload)
    for key in ("config", "traffic", "chips"):
        if entry[key] != cell[key]:
            raise harness.BenchError(
                f"cell {args.workload}: BENCHMARK.json's {key} "
                f"{entry[key]!r} is not its file's {cell[key]!r}")
    import torch
    if device is None:
        torch.set_num_threads(HOST_THREADS)
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            print(f"cell {args.workload} needs {cell['chips']} CUDA "
                  f"device(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return NO_CARD
        device = torch.device("cuda", 0)
    ctx = harness.Context(
        cell=cell, config=harness.load_config(cell["config"]),
        traffic=harness.load_traffic(cell["traffic"]), seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), device=device,
        t_start=T_START if t_start is None else t_start)
    driver = harness.load_module("drivers", cell["driver"], "driver")
    out = driver.run(ctx)

    metrics = {}
    if args.trace:
        for m in harness.per_layer_for(bench, args.workload):
            reader = harness.metric_reader(m["name"])
            value = reader.read(out.readings)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        for m in harness.end_to_end_for(bench, args.workload):
            metrics[m["name"]] = {"value": float(out.metrics[m["name"]]),
                                  "unit": m["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": harness.all_within(out.checks),
              "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": dev}
    if args.trace and out.readings.trace is not None:
        tr = out.readings.trace
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
        # What the readers read, a unit each, for the record.
        r = out.readings
        print(json.dumps({
            "units": r.units, "window_s": r.window_s,
            "traced_units": tr["units"],
            "group_ms": {g: s * 1e3 / tr["units"]
                         for g, s in tr["group_s"].items()},
            "bound_ms": {k: s * 1e3 for k, s in r.bounds.items()},
            "flops_per_unit": r.flops_per_unit}), file=sys.stderr)
    held = harness.forbidden_modules()
    if held:
        print(f"the process holds {held}: a run may not load them",
              file=sys.stderr)
        return FORBIDDEN
    harness.emit(result, out.checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
