"""Run a cell several times, one process a run, and sum up the spread.

    python3 perfbench/sets.py --workload <name> --seconds <s> \
        --seeds <n,n,...> [--trace 0|1] [--out <file>.jsonl]

Each run is ``perfbench/run.py`` with one seed of the list, one after the
other; each result line (with the run's set-up parts and its exit code)
goes to ``--out``. Then, for every metric, the median and the spread as
the benchmark defines it: the distance between the first and the
third quartile (``statistics.quantiles(values, n=4)``) over the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / abs(med) if med else float("nan")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = []
    for seed in args.seeds.split(","):
        t = time.perf_counter()
        p = subprocess.run(
            [sys.executable, str(ROOT / "perfbench" / "run.py"),
             "--workload", args.workload, "--seed", seed,
             "--seconds", args.seconds, "--trace", args.trace],
            capture_output=True, text=True, cwd=ROOT)
        lines = p.stdout.strip().splitlines()
        row = {"seed": int(seed), "rc": p.returncode,
               "wall_s": time.perf_counter() - t}
        try:
            row["parts"] = json.loads(lines[-2])["setup_parts"]
            row["result"] = json.loads(lines[-1])
        except (IndexError, ValueError, KeyError):
            row["stderr"] = p.stderr[-3000:]
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    names = sorted({m for r in rows if "result" in r
                    for m in r["result"]["metrics"]})
    for m in names:
        vals = [r["result"]["metrics"][m]["value"] for r in rows
                if "result" in r and m in r["result"]["metrics"]]
        print(f"{m}: median {statistics.median(vals)!r} spread "
              f"{spread(vals)!r} over {len(vals)}: {vals}")
    checks = [(r["seed"], r["result"]["correct"],
               {n: c["value"] for n, c in r["result"]["checks"].items()})
              for r in rows if "result" in r]
    print("checks:", checks)
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
