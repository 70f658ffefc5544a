"""The readings that a cell's correctness limits are set from, at the cell's
own size, for many seeds in one process:

    python3 -m gpubench.calibrate --workload <cell> --seeds 11,12,13

For each seed, one JSON line with the check's numbers of the port, of the
control (the reference one precision step below the configuration's, in
the port's place) and of each planted fault the driver's ``readings``
runs. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default=None,
                   help="also append each line to this file")
    args = p.parse_args(argv)
    from gpubench import harness
    import torch
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_workload(args.workload)
    driver = harness.load_module("drivers", cell["driver"], "driver")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = harness.Context(
            cell=cell, config=harness.load_config(cell["config"]),
            traffic=harness.load_traffic(cell["traffic"]), seed=seed,
            seconds=0.0, trace=False, device=torch.device("cuda", 0),
            t_start=t)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           **driver.readings(ctx),
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
