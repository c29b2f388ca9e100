#!/usr/bin/env python3
"""Run a cell with its correctness control planted (``controls.py``) on
several seeds; every compared number has to read above its limit (a run
whose sampled units never came reads nothing: give it more seconds).  The
benchmark's own runs never run it.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 --seconds 12
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=12.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench import harness

    _, _, config, traffic = harness.cell_data(args.workload)
    control = harness.load_module("kinds", traffic["kind"]).CONTROL
    seeds = [int(s) for s in args.seeds.split(",")]
    failed = 0
    for seed in seeds:
        with control(config):
            r = harness.run(args.workload, seed, args.seconds, False)
        failed += all(c["value"] > c["limit"] for c in r["compared"].values())
        print(json.dumps({"workload": args.workload, "seed": seed, "control": control.__name__,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "compared": r["compared"]}), flush=True)
    return 0 if failed == len(seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
