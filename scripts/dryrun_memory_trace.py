#!/usr/bin/env python3
"""Hold the dry run's peak live bytes against a real run's, op by op.

    python3 scripts/dryrun_memory_trace.py [--arch A] [--layers N]
        [--device cuda|cpu] [--out DIR]

For each of ``chip_smoke.py`` phase 36's cells (``train_4k`` at batch 4,
``prefill_32k`` at batch 1, on a (1, 1) mesh) the cell is built twice by
``launch/dryrun.py``'s ``lower_cell``: on fake tensors over a one-rank
``fake`` world, as the dry run runs it, and on real tensors (zeroed) over
a one-rank world (``nccl`` on the card, ``gloo`` on the CPU). Both steps
run inside a ``CostMode`` that also records, after each op, its name, the
mode's live bytes and, on the card, the allocator's bytes
(``torch.cuda.memory_allocated``) and the most it held during the op;
on the card the real step then runs once more with no mode. Prints, per
cell, the fake prediction, the real run's ``CostMode`` peak and
``torch.cuda.max_memory_allocated`` with and without the mode (all above
the arguments), the
ops where the allocator's count and the mode's part by more than
``--min-mib``, and the largest live tensors at each peak with the op that
made them. The traces go to ``<out>/<cell>.json``. On the CPU only the
two ``CostMode`` counts are compared. Prints the card's name and power
limit first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = (("train_4k", 4), ("prefill_32k", 1))
MIB = 2 ** 20


def trace_mode(torch, on_card):
    from repro_torch.roofline.comms import CostMode

    class TraceMode(CostMode):
        """``CostMode`` that records each op and the live set at its
        peak."""

        def __init__(self):
            super().__init__()
            self.trace, self.made, self.at_peak = [], {}, []
            self._name = None
            self.base = torch.cuda.memory_allocated() if on_card else 0

        def _allocated(self, outs):
            for t in outs:
                self.made.setdefault(id(t.untyped_storage()), self._name)
            before = self.peak_bytes
            super()._allocated(outs)
            if self.peak_bytes > before:
                self.at_peak = sorted(
                    ((n, self.made.get(k)) for k, n in self._live.items()),
                    key=lambda e: -e[0])[:12]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self._name = str(func)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or self._paused:
                return out
            row = [self._name, self.live_bytes]
            if on_card:
                row += [torch.cuda.memory_allocated() - self.base,
                        torch.cuda.max_memory_allocated() - self.base]
                torch.cuda.reset_peak_memory_stats()
            self.trace.append(row)
            return out
    return TraceMode


def run(torch, args, shape, batch, fake):
    """One cell's step on fake or real tensors; returns the mode and the
    arguments' local bytes."""
    import contextlib

    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.dryrun import _leaves, local_bytes, lower_cell
    from repro_torch.launch.mesh import (make_test_mesh, prepare_groups,
                                         start_fake_world)
    on_card = args.device == "cuda" and not fake
    if fake:
        start_fake_world(1)
    else:
        if dist.is_initialized():
            dist.destroy_process_group()
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group(
            "nccl" if args.device == "cuda" else "gloo",
            init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    mesh = make_test_mesh((1, 1), ("data", "model"), args.device)
    prepare_groups(mesh)
    with FakeTensorMode() if fake else contextlib.nullcontext():
        step, cell_args, _ = lower_cell(
            args.arch, shape, mesh, args.layers, device=args.device,
            batch_override=batch)
        leaves = _leaves(cell_args)
        if not fake:
            with torch.no_grad():
                for t in leaves:         # uninitialised → zeros: valid ids
                    (t.to_local() if hasattr(t, "to_local") else t).zero_()
        arg_bytes = sum(local_bytes(t) for t in leaves)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        with implicit_replication(), trace_mode(torch, on_card)() as cm:
            out = step()
            del out
        if on_card:
            # the same step again with no mode: the allocator alone
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with implicit_replication():
                out = step()
                del out
            torch.cuda.synchronize()
            cm.no_mode_peak = torch.cuda.max_memory_allocated() - base
    del step, cell_args, leaves
    dist.destroy_process_group()
    return cm, arg_bytes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--min-mib", type=float, default=64.0)
    ap.add_argument("--out", default="build/dryrun_memory_trace")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src")]
    import gc

    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("no CUDA device (pass --device cpu)")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    summary = {}
    for shape, batch in CELLS:
        res = {}
        for kind in ("fake", "real"):
            cm, arg_bytes = run(torch, args, shape, batch, kind == "fake")
            res[kind] = (cm, arg_bytes)
            gc.collect()
            if args.device == "cuda":
                torch.cuda.empty_cache()
        (fk, fk_args), (rl, rl_args) = res["fake"], res["real"]
        row = {"arguments_gib": rl_args / 2 ** 30,
               "fake_peak_gib": fk.peak_bytes / 2 ** 30,
               "real_costmode_peak_gib": rl.peak_bytes / 2 ** 30,
               "fake_ops": len(fk.trace), "real_ops": len(rl.trace),
               "first_op_mismatch": next(
                   (i for i, (a, b) in enumerate(zip(fk.trace, rl.trace))
                    if a[0] != b[0]), None)}
        if args.device == "cuda":
            row["real_allocator_peak_gib"] = max(
                r[3] for r in rl.trace) / 2 ** 30
            row["real_no_mode_allocator_peak_gib"] = rl.no_mode_peak / 2 ** 30
        print(f"[{args.arch} L{args.layers} {shape} B{batch}] "
              + json.dumps(row))
        if args.device == "cuda":
            prev = 0
            for i, (name, live, alloc, peak) in enumerate(rl.trace):
                gap = alloc - live
                if abs(gap - prev) > args.min_mib * MIB \
                        or peak - alloc > args.min_mib * MIB:
                    print(f"  op {i} {name}: allocator {alloc / MIB:.1f} "
                          f"MiB (most in the op {peak / MIB:.1f}), mode "
                          f"{live / MIB:.1f} MiB, gap {gap / MIB:+.1f}")
                prev = gap
        for kind, cm in (("fake", fk), ("real", rl)):
            print(f"  {kind} peak live set (MiB, made by): " + ", ".join(
                f"{n / MIB:.1f} {op}" for n, op in cm.at_peak))
        (out_dir / f"{shape}.json").write_text(json.dumps(
            {"summary": row, "fake": fk.trace, "real": rl.trace}))
        summary[shape] = row
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
