"""
The spreads the bounds of BENCHMARK.json are set from.

    python3 -m cardbench.bounds --set A1.out A2.out ... --set B1.out ...

Each file holds one run's output (its last line is the result). For each
metric and set it prints the median and the spread: the distance between
the first and third quartiles as a share of the median, the quartiles as
Python's statistics.quantiles(values, n=4) gives them. A bound is about
five times the widest spread over the sets and cells, and never under 1%.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from .stats import spread


def lines(paths) -> list:
    out = []
    for p in paths:
        with open(p) as f:
            text = f.read().strip().splitlines()
        out.append(json.loads(text[-1]))
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cardbench.bounds")
    ap.add_argument("--set", nargs="+", action="append", required=True)
    sets = [lines(s) for s in ap.parse_args(argv).set]
    names = sorted({k for rows in sets for r in rows for k in r["metrics"]})
    for name in names:
        widest = 0.0
        for i, rows in enumerate(sets):
            vals = [r["metrics"][name]["value"] for r in rows
                    if name in r["metrics"]]
            if len(vals) < 2:
                continue
            sp = spread(vals)
            widest = max(widest, sp)
            print(f"{name} set {i + 1}: median {statistics.median(vals)!r} "
                  f"spread {sp:.6f} of {len(vals)} runs: {vals}")
        print(f"{name}: widest spread {widest:.6f}, five times "
              f"{5 * widest:.6f}")
    for i, rows in enumerate(sets):
        print(f"set {i + 1}: correct {[r['correct'] for r in rows]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
