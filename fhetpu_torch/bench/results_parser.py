"""Aggregate-results reloader: reads the ``analyze`` output back into a
{(pipeline, poly_n, plain_mod, dbc): {label: (mean, std)}} dict, and
averages over the plain modulus like the reference's results_parser.py.

The port's own copy of ``fhetpu/bench/results_parser.py``.

    python -m fhetpu_torch.bench.results_parser [results.txt]
"""

from __future__ import annotations

import re
from collections import defaultdict


def parse_results(path: str):
    data = defaultdict(dict)
    current = None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.startswith("  "):
                m = re.match(r"(\w+)_(\d+)_(\d+)_(\d+)", line.strip())
                if m:
                    kind, n, pmod, dbc = m.groups()
                    current = (kind, int(n), int(pmod), int(dbc))
            elif current:
                label, mean, std = line.strip().split(",")
                data[current][label] = (float(mean), float(std))
    return dict(data)


def average_over_pmod(data):
    """{(kind, n): {label: mean-of-means}} like the reference's final dict."""
    agg = defaultdict(lambda: defaultdict(list))
    for (kind, n, pmod, dbc), stats in data.items():
        for label, (mean, _) in stats.items():
            agg[(kind, n)][label].append(mean)
    return {
        key: {label: sum(v) / len(v) for label, v in stats.items()}
        for key, stats in agg.items()
    }


if __name__ == "__main__":
    import sys

    data = parse_results(sys.argv[1] if len(sys.argv) > 1 else "results.txt")
    for key, stats in sorted(average_over_pmod(data).items()):
        print(key, stats)
