"""
The readings the limits of `correct` are set from, on the card at a
cell's own size; the benchmark's runs never call it.

    python3 -m cardbench.calibrate --workload <cell> --seeds 101 ... 112 \\
        [--control 3] [--seconds 2]

For each seed it drives the cell's timed path for a short window exactly
as a run does (the same set-up, jobs and sample) and judges it with the
run's own `check`: the program's readings, whose largest over the seeds is
a limit's lower reading. For the first `--control` seeds it also puts the
control in the program's place, the plain reference computed a step below
the configuration's float32 (bfloat16 terms summed in float32), and
judges it with the same `check`: its smallest readings are a limit's upper
reading, and its `correct` has to come out false. One JSON line a reading
on stdout, and the summary last.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import compare, registry
from .run import card, check, measure


def _record(side, seed, checks, limits, correct) -> dict:
    return dict({"seed": seed, "side": side}, **checks, correct=correct,
                limits=limits)


def main(argv) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python3 -m cardbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = registry.load_cell(args.workload)
    device = card(cell.chips)
    if device is None:
        return 2
    config = cell.config
    lows, highs, control_correct = {}, {}, []
    for i, seed in enumerate(args.seeds):
        run, points, sample, _, failed, _ = measure(
            cell, seed, args.seconds, False, t0, device)
        results = sample.rasters()
        del sample, run
        checks, limits, correct = check(config, points, results, failed,
                                        device)
        del results
        print(json.dumps(_record("program", seed, checks, limits, correct)),
              flush=True)
        for k, v in checks.items():
            lows[k] = max(lows.get(k, v), v)
        if i < args.control:
            ctl = compare.references(config, points, device, control=True)
            ctl = [tuple(c.cpu().numpy() for c in ctl)]
            checks, limits, correct = check(config, points, ctl, 0, device)
            del ctl
            print(json.dumps(_record("control", seed, checks, limits,
                                     correct)), flush=True)
            control_correct.append(correct)
            for k, v in checks.items():
                highs[k] = min(highs.get(k, v), v)
        del points
    print(json.dumps({"workload": args.workload, "lower": lows,
                      "upper": highs, "control_correct": control_correct,
                      "limits": config["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
