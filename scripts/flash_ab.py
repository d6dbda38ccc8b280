#!/usr/bin/env python3
"""Time two builds of the flash-attention source against each other on one
NVIDIA GPU, in turns (A, B, B, A), at the shapes ``chip_smoke.py`` phase 2
runs #9 at.

    python3 scripts/flash_ab.py A.cu B.cu [--iters N]

Each source is compiled with ``nvcc`` (the port's flags) into its own
library under ``build/flash_ab/`` (each kernel's registers and spills
printed from ``ptxas -v``) and called through its C entry
``flash_attention_launch``; a source whose entry takes no v width (one
width for q, k and v) is called without it, and skips the shapes whose v
width differs. Each (shape, dtype) is timed with CUDA events around
``--iters`` launches, host-paced as ``chip_smoke.py``'s ``ms``, after a
warm-up. Where both builds run the shape, the two bf16 outputs must agree
bit for bit; each fp32 output must be within the fp32 tolerance of the
plain version, and where both sources hold the 3xTF32 kernel
(``flash_attention_tf32x3_kernel``) the two fp32 outputs must also agree
bit for bit (across kernel families, CUDA-core FMAs against 3xTF32 on the
tensor cores, the arithmetic differs). Prints the card's name and
power limit, a line per (shape, dtype), and last a JSON object of the
times.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (what, B, Sq, Skv, H, K, D, DV, causal): phase 2's #9 shapes
SHAPES = [
    ("internlm2-1.8b", 1, 4096, 4096, 16, 8, 128, 128, True),
    ("internlm2-1.8b train", 4, 2048, 2048, 16, 8, 128, 128, True),
    ("zamba2-1.2b", 1, 4096, 4096, 32, 32, 64, 64, True),
    ("zamba2-1.2b", 1, 1100, 1100, 32, 32, 64, 64, True),
    ("seamless encoder", 1, 4096, 4096, 16, 16, 64, 64, False),
    ("seamless cross", 1, 600, 4096, 16, 16, 64, 64, False),
    ("seamless decode cross", 1, 1, 4096, 16, 16, 64, 64, False),
    ("llava-next", 1, 2944, 2944, 32, 8, 128, 128, True),
    ("deepseek-v2 MLA", 1, 4096, 4096, 128, 128, 192, 128, True),
    ("deepseek-v2 MLA", 1, 1100, 1100, 128, 128, 192, 128, True),
]


def build(src: Path, label: str):
    """Compile ``src`` into ``build/flash_ab/<label>.so``; returns the C
    entry and whether it takes a v width."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    out = ROOT / "build" / "flash_ab" / f"{label}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(out),
                           str(src)], check=True, capture_output=True,
                          text=True)
    from chip_smoke import ptxas_kernels
    for k in ptxas_kernels(proc.stdout + proc.stderr):
        print(f"{label}: {k['name']}: {k['regs']} registers, "
              f"{k['spill_stores']} B spill stores, {k['spill_loads']} B "
              f"spill loads")
    has_dv = re.search(r"int D,\s*int DV,", src.read_text()) is not None
    fn = ctypes.CDLL(str(out)).flash_attention_launch
    c, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([c] * 4 + [i] * (8 if has_dv else 7)
                   + [ctypes.c_float, i, c])
    fn.restype = i
    return fn, has_dv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_ab: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = {"A": build(args.a, "A"), "B": build(args.b, "B")}
    # fp32 bit for bit between the builds too when both are 3xTF32
    fp32_same_family = all("flash_attention_tf32x3_kernel" in p.read_text()
                           for p in (args.a, args.b))
    dev = torch.device("cuda", 0)
    results = []
    for what, B, Sq, Skv, H, K, D, DV, causal in SHAPES:
        for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
            g = torch.Generator(dev).manual_seed(0)
            q = torch.randn((B, Sq, H, D), generator=g, device=dev).to(dtype)
            k = torch.randn((B, Skv, K, D), generator=g, device=dev).to(dtype)
            v = torch.randn((B, Skv, K, DV), generator=g,
                            device=dev).to(dtype)
            stream = torch.cuda.current_stream(dev).cuda_stream
            outs, ms = {}, {"A": [], "B": []}

            def launch(label):
                fn, has_dv = libs[label]
                out = outs.setdefault(label, q.new_empty((B, Sq, H, DV)))
                dims = (D, DV) if has_dv else (D,)
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), B, Sq, Skv, H, K, *dims, int(causal),
                        1.0 / D ** 0.5, code, stream)
                if rc:
                    raise RuntimeError(f"{label}: cudaError {rc}")

            runs = [lb for lb in ("A", "B", "B", "A")
                    if libs[lb][1] or D == DV]
            for label in runs:
                launch(label)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.iters):
                    launch(label)
                end.record()
                torch.cuda.synchronize()
                ms[label].append(start.elapsed_time(end) / args.iters)
            same = (torch.equal(outs["A"], outs["B"])
                    if len(outs) == 2 else None)
            if same is False and (dtype == torch.bfloat16
                                  or fp32_same_family):
                raise AssertionError(f"{what} {dtype}: A and B differ")
            err = {}
            if dtype == torch.float32:
                from chip_smoke import TOL
                from repro_torch.kernels.flash_attention.ref import \
                    flash_attention_ref
                ref = flash_attention_ref(q, k, v, causal=causal,
                                          scale=1.0 / D ** 0.5)
                atol, rtol = TOL["float32"]
                for label, out in outs.items():
                    torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)
                    err[label] = float((out - ref).abs().max())
                del ref
            row = {"what": what, "dtype": str(dtype)[6:], "Sq": Sq,
                   "Skv": Skv, "H": H, "K": K, "D": D, "DV": DV,
                   "causal": causal, "ms_A": ms["A"], "ms_B": ms["B"],
                   "bitwise_equal": same, "max_abs_err_vs_plain": err}
            results.append(row)
            print(f"{what} {row['dtype']} Sq={Sq} Skv={Skv} H={H} K={K} "
                  f"D={D} DV={DV} causal={causal}: A {ms['A']} ms, B "
                  f"{ms['B']} ms, bit for bit {same}"
                  + (f", vs plain {err}" if err else ""), flush=True)
            del q, k, v, outs
            torch.cuda.empty_cache()
    print(json.dumps({"flash_ab": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
