"""The readings that the limits of ``correct`` are set from: for each seed,
the numbers compared for the program (the lower readings) and for the
control, the plain reference computed in the next precision below the
configuration's (bfloat16 for float32) and put in the program's place (the
upper readings).

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--seconds 3]

Each seed runs the cell's set-up and a short window at the cell's own
shapes in this one process, then the reference over the same sample of the
window's outputs that a benchmark run compares; prints one JSON line a seed
and, last, the largest program reading and the smallest control reading of
each number.  The benchmark's own runs do not run the control.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .run import Catalog, _merge, driver_class

# the next precision below the one a configuration states
LOWER = {"float32": torch.bfloat16}


def readings(name, seeds, seconds, device, traffic_overrides=None, catalog=None):
    """[(seed, program readings, control readings)] of cell ``name``."""
    catalog = catalog or Catalog()
    cell = catalog.cell(name)
    config = catalog.config(cell)
    traffic = _merge(catalog.traffic(cell), traffic_overrides)
    out = []
    for seed in seeds:
        driver = driver_class(traffic["driver"])(config, traffic, seed, device)
        driver.warm_up()
        driver.window(seconds)
        driver.collect()
        sound, control = driver.readings(LOWER[config["precision"]])
        out.append((seed, sound, control))
        print(json.dumps({"workload": name, "seed": seed, "program": sound,
                          "control": control}), flush=True)
        del driver
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds,
                    args.device)
    keys = rows[0][1].keys()
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "program_max": {k: max(r[1][k] for r in rows) for k in keys},
                      "control_min": {k: min(r[2][k] for r in rows) for k in keys}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
