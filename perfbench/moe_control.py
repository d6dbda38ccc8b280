"""The control of the DeepSeek-V2 cell's correctness check, on the card:
:mod:`perfbench.control` for a cell whose loop is ``closed_moe``.

    python3 perfbench/moe_control.py --workload <name> --seconds <s> \
        --seeds <n,n,n> [--out <file>.jsonl]

For each seed it runs the cell as the benchmark does (set-up, the window,
the program freed, the fp32 reference of
:mod:`perfbench.reference.moe_decoder`), then the control: the reference
put in the program's place with every weight product's weight and input
rounded to float8 e4m3, the next precision below the configuration's
bfloat16. At each served position it reads the fp32 reference's gap of
the token the fp8 model puts first. One line a seed: the program's
readings (``closed_moe.gap_readings``: the widest and the mean gap)
beside the control's, and each one's spread of gaps. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed, seconds, device, t_start, kind):
    from perfbench import bench, moe_weights
    from perfbench.control import _gap_stats
    from perfbench.loops.closed_moe import gap_readings
    from perfbench.reference import moe_decoder
    result, out = bench.run_cell(cell, seed, seconds, False, device, t_start,
                                 kind)
    pairs = out.ctx["pairs"]
    g = moe_decoder.control_gaps(moe_weights.MoEArch(cell.config), seed,
                                 pairs, device)
    return {"seed": seed, "correct": result["correct"],
            "program": gap_readings(out.ctx["gaps"]),
            "control": gap_readings(g),
            "served_tokens": out.ctx["served_tokens"],
            "metrics": {n: m["value"] for n, m in result["metrics"].items()},
            "spread_of_gaps": {"program": _gap_stats(out.ctx["gaps"]),
                               "control": _gap_stats(g)}}


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
        print("moe_control: no CUDA device", file=sys.stderr)
        return 2
    cell = bench.resolve(args.workload)
    if cell.traffic["loop"] != "closed_moe":
        print(f"moe_control: {args.workload} is no closed_moe cell; use "
              f"perfbench/control.py", file=sys.stderr)
        return 2
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
    if Path(sys.path[0]).resolve() == ROOT / "perfbench":
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
