"""The control and the faults of a cell's correctness check, on the card.

    python3 perfbench/control.py --workload <name> --seconds <s> \
        --seeds <n,n,n> [--out <file>.jsonl]

For each seed it runs the cell as the benchmark does (set-up, the window,
the program freed, the fp32 reference) and then the control: the
reference put in the program's place in the next precision below the
configuration's bfloat16, float8 e4m3 (every matrix product's weight and
input rounded to it). A serving cell reads, at each served position, the
fp32 reference's gap of the token the fp8 model puts first; a train cell
runs the checked steps in fp8 and, as a planted fault, in fp32 on half of
each batch (the mean over the rest), and compares each with the fp32
reference as the program is compared. It prints one line a seed: the
program's readings beside the control's and the faults'. The benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
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


def readings(cell, seed, seconds, device, t_start, kind):
    from perfbench import bench, weights
    from perfbench.reference import decoder, train
    result, out = bench.run_cell(cell, seed, seconds, False, device, t_start,
                                 kind)
    row = {"seed": seed, "correct": result["correct"],
           "program": {n: c["value"] for n, c in result["checks"].items()},
           "metrics": {n: m["value"] for n, m in result["metrics"].items()}}
    a = weights.Arch(cell.config)
    if cell.traffic["loop"] == "train":
        ctx, opt = out.ctx, cell.traffic["optimizer"]
        low = train.train(a, seed, ctx["batches"], opt, device, quant="fp8")
        row["control"] = train.gaps(low, ctx["reference"])
        half = [{k: v[: len(v) // 2] for k, v in b.items()}
                for b in ctx["batches"]]
        row["half_batch"] = train.gaps(train.train(a, seed, half, opt,
                                                   device), ctx["reference"])
    else:
        pairs = out.ctx["pairs"]
        g = decoder.control_gaps(a, seed, pairs, device)
        row["control"] = {"logit_gap": max(float(x.max()) for x in g)}
        row["served_tokens"] = out.ctx["served_tokens"]
        row["spread_of_gaps"] = {k: _gap_stats(v) for k, v in
                                 (("program", out.ctx["gaps"]),
                                  ("control", g))}
    return row


def _gap_stats(gaps) -> dict:
    import torch
    g = torch.cat(list(gaps)).double()
    return {"widest": float(g.max()), "mean": float(g.mean()),
            "p99": float(torch.quantile(g, 0.99)),
            "share_not_best": float((g > 0).double().mean())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from perfbench import bench
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = bench.resolve(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds.split(","):
        t = time.perf_counter()
        row = readings(cell, int(seed), args.seconds, device, t,
                       torch.cuda.get_device_name(0))
        row["wall_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    _as_script()
    sys.exit(main())
