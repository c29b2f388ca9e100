#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA card (exits non-zero without one, or with fewer than the cell
asks for) and the program, ``fhetpu_torch``, beside ``perfbench/``.  Every
build and kernel cache stays inside the checkout, under ``.perfbench_cache/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".perfbench_cache")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        chips = {w["name"]: w["chips"] for w in json.load(f)["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = harness.leftover_modules()
    if loaded:
        print(f"perfbench: the run loaded {loaded}, which the port's benchmark must not",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"perfbench: compared {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
