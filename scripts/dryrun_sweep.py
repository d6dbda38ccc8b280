#!/usr/bin/env python3
"""The dry run's whole sweep, one process a cell, several at once, and a
table of its artifacts.

    python3 scripts/dryrun_sweep.py --out DIR [--layers N] [--jobs 8]
        [--device cuda|cpu] [--src SRC] [--timeout SECONDS]
    python3 scripts/dryrun_sweep.py --table DIR [DIR ...]

The first form steps every (arch × shape × mesh) cell of
``python -m repro_torch.launch.dryrun --all --mesh both`` (at ``--layers``
depth, all layers without it), each in its own process of ``-m
repro_torch.launch.dryrun`` with ``PYTHONPATH=SRC`` (``src`` of this
checkout by default; another tree's ``src`` runs that tree's dry run, the
cells' list coming from this one's CLI, ``sweep_cells``), ``--jobs`` at
once; a cell past ``--timeout`` seconds is killed and counted failed, and
so is one whose artifact counts a ``Partial`` at a ``local_map`` input
(``partial_guard_fires``). It writes each
cell's artifact and log under DIR, and ``DIR/sweep.json``: one record a
cell (status, the process's wall seconds, the artifact's figures). It
prints the table, then one line ``ok N failed N skipped N``, and exits 1
if a cell failed. The seconds are the wall time of a cell's process
(Python's start and the fake world's included) while ``--jobs`` cells
run at once.

The second form prints one table of one or more such directories, a row
an (arch, shape) with its pod and multipod cells side by side (the
first's figures, then each other's at the same depth as "same" or its
own, and one at another depth by its live bytes), for ``PERF.md``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cells():
    """The cells of the dry run's ``--all --mesh both``, in its order, and
    its skipped ones (:func:`repro_torch.launch.dryrun.sweep_cells`)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.dryrun import sweep_cells
    return sweep_cells()


def tag(arch, shape, multi, layers):
    t = f"{arch}__{shape}__{'multipod' if multi else 'pod'}"
    return t + (f"__L{layers}" if layers else "")


def run_one(cell, args, out: Path) -> dict:
    arch, shape, multi = cell
    name = tag(arch, shape, multi, args.layers)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", "multi" if multi else "single",
           "--device", args.device, "--out", str(out)]
    if args.layers:
        cmd += ["--layers", str(args.layers)]
    env = dict(os.environ, PYTHONPATH=str(Path(args.src).resolve()))
    env.pop("REPRO_TEST_MESH", None)
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=args.timeout)
        rc, text = r.returncode, r.stdout + r.stderr
    except subprocess.TimeoutExpired as e:
        rc = "timeout"
        text = (e.stdout or b"").decode() if isinstance(e.stdout, bytes) \
            else (e.stdout or "")
    secs = time.time() - t0
    (out / "logs").mkdir(parents=True, exist_ok=True)
    (out / "logs" / f"{name}.log").write_text(text)
    rec = {"arch": arch, "shape": shape,
           "mesh": "multipod" if multi else "pod", "rc": rc,
           "seconds": round(secs, 2), "status": "ok" if rc == 0 else "FAIL",
           "error": None}
    art = out / f"{name}.json"
    if rc != 0:
        lines = [ln for ln in text.splitlines() if ln.startswith("[FAIL]")]
        rec["error"] = lines[-1] if lines else f"rc {rc}"
    elif art.exists():
        a = json.loads(art.read_text())
        c = a["collectives"]
        rec.update(live_gb=a["per_device_live_bytes"] / 1e9,
                   argument_gb=a["memory"]["argument_bytes"] / 1e9,
                   collectives=c["num_ops"],
                   wire_gb=c["total_wire_bytes"] / 1e9,
                   flops=a["cost"]["flops"], fits_hbm=a["fits_hbm"],
                   partial_guard_fires=a.get("partial_guard_fires"),
                   run_s=a["run_s"])
        if rec["partial_guard_fires"]:
            rec.update(status="FAIL", error="partial_guard_fires "
                       f"{rec['partial_guard_fires']}")
    print(f"[{rec['status']}] {name} {rec['seconds']} s"
          + (f": {rec['error']}" if rec["error"] else ""), flush=True)
    return rec


def _counts(rec) -> str:
    return (f"{rec['live_gb']:.3f} ({rec['argument_gb']:.3f}) | "
            f"{rec['collectives']} | {rec['wire_gb']:.3f} | "
            f"{rec['flops']:.4e}")


def _same(rec, base) -> bool:
    """The same collectives, wire bytes, flops and arguments, and live
    bytes within 2%."""
    return all(rec[k] == base[k] for k in ("collectives", "wire_gb", "flops",
                                           "argument_gb")) \
        and abs(rec["live_gb"] - base["live_gb"]) <= 0.02 * base["live_gb"]


def table(dirs) -> str:
    """One row a (arch, shape), its pod and multipod cells side by side;
    for each: the first sweep's figures (live GB with the arguments',
    collectives, wire GB, flops, ``fits_hbm``, seconds); for each further
    sweep at the same depth, "same" (``_same``) or its figures, and its
    seconds; for one at another depth, its live GB, ``fits_hbm`` and
    seconds."""
    sweeps = [json.loads((Path(d) / "sweep.json").read_text())
              for d in dirs]
    runs = [{(r["arch"], r["shape"], r["mesh"]): r for r in sw["cells"]}
            for sw in sweeps]
    group = ["live GB (args)", "colls", "wire GB", "flops", "fits", "s"]
    for sw in sweeps[1:]:
        group += (["counts", "s"] if sw["layers"] == sweeps[0]["layers"]
                  else ["live GB (args)", "fits", "s"])
    meshes = ("pod", "multipod")
    head = ["arch × shape"] + [f"{m}: {g}" if i == 0 else g
                               for m in meshes for i, g in enumerate(group)]
    lines = ["| " + " | ".join(head) + " |", "|---" * len(head) + "|"]
    for arch, shape in dict.fromkeys((k[0], k[1]) for k in runs[0]):
        row = [f"{arch} × {shape}"]
        for mesh in meshes:
            row += _cells(sweeps, runs, (arch, shape, mesh))
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


def _cells(sweeps, runs, key) -> list:
    base = runs[0].get(key)
    ok = base is not None and base["status"] == "ok"
    if base is None:
        out = ["—", "", "", "", "", ""]
    elif ok:
        out = _counts(base).split(" | ") + [
            "yes" if base["fits_hbm"] else "NO", str(base["seconds"])]
    else:
        out = [base["status"], "", "", "", "", str(base["seconds"])]
    for sw, run in zip(sweeps[1:], runs[1:]):
        rec = run.get(key)
        same_depth = sw["layers"] == sweeps[0]["layers"]
        if rec is None or rec["status"] != "ok":
            st = "—" if rec is None else rec["status"]
            out += [st, ""] if same_depth else [st, "", ""]
        elif same_depth:
            out += ["same" if ok and _same(rec, base)
                    else _counts(rec).replace(" | ", ", "),
                    str(rec["seconds"])]
        else:
            out += [f"{rec['live_gb']:.2f} ({rec['argument_gb']:.3f})",
                    "yes" if rec["fits_hbm"] else "NO",
                    str(rec["seconds"])]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--timeout", type=float, default=1800)
    ap.add_argument("--table", nargs="+")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.table))
        return 0
    if not args.out:
        ap.error("--out or --table")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    run, skip = cells()
    t0 = time.time()
    # the longest cells (train, then prefill) first, so the last to end
    # are short; the records keep the sweep's order
    order = ("train_4k", "prefill_32k")
    first = sorted(run, key=lambda c: order.index(c[1]) if c[1] in order
                   else len(order))
    with ThreadPoolExecutor(args.jobs) as pool:
        done = dict(zip(first, pool.map(lambda c: run_one(c, args, out),
                                        first)))
    recs = [done[c] for c in run]
    summary = {"layers": args.layers, "device": args.device,
               "src": str(args.src), "jobs": args.jobs,
               "wall_s": round(time.time() - t0, 1), "cells": recs,
               "skipped": [list(s) for s in skip]}
    (out / "sweep.json").write_text(json.dumps(summary, indent=1))
    print(table([out]))
    for arch, shape, why in skip:
        print(f"[skip] {arch} × {shape}: {why}")
    bad = sum(r["status"] != "ok" for r in recs)
    print(f"ok {len(recs) - bad} failed {bad} skipped {len(skip)} "
          f"wall {summary['wall_s']} s", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
