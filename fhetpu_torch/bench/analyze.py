"""Log aggregator: parses the per-op CSV rows ('Label,ms,ms,...,') of the
sweep logs and prints mean/std per label.

The port's own copy of ``fhetpu/bench/analyze.py`` (same ``LABELS``, same
output), defaulting to ``benchmark``'s log directory.

    python -m fhetpu_torch.bench.analyze [LOGDIR] [--results FILE]
"""

from __future__ import annotations

import argparse
import glob
import math
import os
from collections import defaultdict

LABELS = ("Encryption", "Decryption", "DCT", "RGBYCC", "Linear", "Cubic",
          "Step", "RMSError")


def parse_log(path):
    out = defaultdict(list)
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if parts and parts[0] in LABELS:
                for v in parts[1:]:
                    if v:
                        try:
                            out[parts[0]].append(float(v))
                        except ValueError:
                            pass
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("logdir", nargs="?", default="./benchlogs_torch")
    ap.add_argument("--results", default=None, help="write aggregate file")
    args = ap.parse_args()
    lines = []
    for path in sorted(glob.glob(os.path.join(args.logdir, "*.txt"))):
        stats = parse_log(path)
        name = os.path.basename(path)[:-4]
        lines.append(name)
        for label, vals in stats.items():
            mean = sum(vals) / len(vals)
            var = sum((v - mean) ** 2 for v in vals) / len(vals)
            lines.append(f"  {label},{mean:.6g},{math.sqrt(var):.6g}")
    text = "\n".join(lines)
    print(text)
    if args.results:
        with open(args.results, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
