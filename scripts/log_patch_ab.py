#!/usr/bin/env python3
"""Time two builds of the log-patch source against each other on one NVIDIA
GPU, in turns (A, B, B, A), at ``chip_smoke.py`` phase 2's shape
(``LOG_GEOM``: P=682 pages of T=16 slots, C=2048, N=256 records with
colliding targets, skipped records and out-of-range indices).

    python3 scripts/log_patch_ab.py A.cu B.cu [--iters N]

Each source is compiled with ``nvcc`` (the port's flags) into its own
library under ``build/log_patch_ab/`` and called through its C entry
``log_patch_launch``, for a bf16 pool, an fp32 pool, and fp32 payloads into
a bf16 pool. Each case is timed with CUDA events around ``--iters``
launches enqueued while the card sleeps (the card's time alone, as
``chip_smoke.py``'s ``card_ms``), after a warm-up; both outputs must be bit
for bit the plain version's. Each case's bytes bound is
``chip_smoke.log_patch_bytes`` over the card's memory rate. Prints the card's name and power limit, a line
per case, and last a JSON object of the times.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def build(src: Path, label: str):
    """Compile ``src`` into ``build/log_patch_ab/<label>.so``; returns its
    C entry."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    out = ROOT / "build" / "log_patch_ab" / f"{label}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).log_patch_launch
    c, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [c] * 6 + [i] * 6 + [c]
    fn.restype = i
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("log_patch_ab: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import (HBM_BYTES_PER_S, LOG_GEOM, SLEEP_CYCLES,
                            log_patch_bytes, log_records)
    from repro_torch.kernels.log_patch.ref import log_patch_ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = {"A": build(args.a, "A"), "B": build(args.b, "B")}
    dev = torch.device("cuda", 0)
    P, T, C, N = (LOG_GEOM[k] for k in "P T C N".split())
    code = {torch.float32: 0, torch.bfloat16: 1}
    results = []
    for pool_dt, pay_dt in ((torch.bfloat16, torch.bfloat16),
                            (torch.float32, torch.float32),
                            (torch.bfloat16, torch.float32)):
        g = torch.Generator(dev).manual_seed(1)
        pool = torch.randn((P, T, C), generator=g, device=dev).to(pool_dt)
        pays = torch.randn((N, C), generator=g, device=dev).to(pay_dt)
        pg, sl, valid = log_records(torch, g, dev, P, T, N)
        want = log_patch_ref(pool, pays, pg, sl, valid)
        targets = pg.long().clamp(0, P - 1) * T + sl.long().clamp(0, T - 1)
        n_win = torch.unique(targets[valid != 0]).numel()
        bound_ms = (log_patch_bytes(pool, pays, n_win, N) / HBM_BYTES_PER_S
                    * 1e3)
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs, ms = {}, {"A": [], "B": []}

        def launch(label):
            out = outs.setdefault(label, torch.empty_like(pool))
            rc = libs[label](pool.data_ptr(), pays.data_ptr(), pg.data_ptr(),
                             sl.data_ptr(), valid.data_ptr(), out.data_ptr(),
                             P, T, C, N, code[pool_dt], code[pay_dt], stream)
            if rc:
                raise RuntimeError(f"{label}: cudaError {rc}")

        for label in ("A", "B", "B", "A"):
            launch(label)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            for _ in range(args.iters):
                launch(label)
            end.record()
            torch.cuda.synchronize()
            ms[label].append(start.elapsed_time(end) / args.iters)
        for label, out in outs.items():
            if not torch.equal(out, want):
                raise AssertionError(f"{label} {pool_dt} {pay_dt}: not bit "
                                     f"for bit the plain version")
        what = f"pool {str(pool_dt)[6:]} payloads {str(pay_dt)[6:]}"
        row = {"what": what, "P": P, "T": T, "C": C, "N": N,
               "card_ms_A": ms["A"], "card_ms_B": ms["B"],
               "bound_ms": bound_ms,
               "bitwise_equal": True}
        results.append(row)
        print(f"{what} P={P} T={T} C={C} N={N}: A {ms['A']} ms, B "
              f"{ms['B']} ms (card), bound {bound_ms:.4f} ms, both bit for "
              f"bit the plain version",
              flush=True)
        del pool, pays, outs, want
        torch.cuda.empty_cache()
    print(json.dumps({"log_patch_ab": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
