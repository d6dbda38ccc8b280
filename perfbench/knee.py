"""Find an open-loop cell's knee: the highest rate at which the waiting
queue does not grow over a window.

    python3 perfbench/knee.py --workload <name> --rates 3,4,5 \
        --seconds <s> --seed <n>

For each rate it builds the cell's program afresh (weights from the
seed), runs the mix's ramp and a window at that rate, and prints the
waiting queue over the window (at its start, the mean of each half, at
its end), the requests due in the window and those still waiting when it
closed, and the TTFT and ITL tails. No reference runs. The rate the cell
uses is then written into its traffic file by hand, with the sweep.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _as_script() -> None:
    """Run as ``python3 perfbench/<this>.py``: the package by its name,
    not this folder's modules as top-level ones, and the port from src/."""
    if Path(sys.path[0]).resolve() == ROOT / "perfbench":
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from perfbench import bench
    from perfbench.loops import open as open_loop
    from perfbench.loops.serving import ServeRun, percentile
    cell = bench.resolve(args.workload)
    device = torch.device("cuda", 0)
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic["rate_per_s"] = rate
        R = ServeRun(cell, args.seed, args.seconds, False, device,
                     time.perf_counter())
        backlog: list = []
        due = open_loop.drive(R, cell.traffic, args.seed, args.seconds,
                              backlog)
        n = np.array([b for _, b in backlog], np.float64)
        half = len(n) // 2
        row = {"rate_per_s": rate, "due": len(due),
               "waiting_at_open": int(n[0]) if len(n) else 0,
               "waiting_mean_first_half": float(n[:half].mean()),
               "waiting_mean_second_half": float(n[half:].mean()),
               "waiting_at_close": int(n[-1]) if len(n) else 0,
               "not_admitted_at_close": sum(
                   tr.admitted is None or tr.admitted >= R.t1 for tr in due),
               "ttft_p90_ms": 1e3 * percentile(
                   [tr.first - tr.due for tr in due], 90),
               "itl_p95_ms": 1e3 * percentile(R.itl, 95),
               "ticks": R.sched.stats.ticks}
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        del R
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    _as_script()
    sys.exit(main())
