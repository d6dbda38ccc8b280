"""One run of one cell: resolve it by name, run its loop, print the line.

A cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
and a traffic mix; everything else is found by name:

* the configuration: the ``file`` of its ``configs`` entry;
* the traffic mix: ``perfbench/traffic/<traffic>.json``; its ``loop``
  names the loop kind, ``perfbench/loops/<loop>.py`` (``run(cell, seed,
  seconds, trace, device, t_start)`` returns an :class:`Outcome`);
* the limits of its correctness check: ``perfbench/limits/<cell>.json``;
* the metrics it reports: the ``end_to_end`` and ``per_layer`` entries
  whose ``workloads`` list names it (or that have no such list); a
  per-layer metric ``m`` is read by ``read(ctx)`` of
  ``perfbench/metrics/<m>.py`` from the context its loop leaves, and one
  that finds nothing to read returns None and is left out of the line.

So a new cell is data: a configuration file, a traffic file, a limits
file, metric readers, and ``BENCHMARK.json`` entries.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


@dataclass
class Outcome:
    """What a loop hands back: the end-to-end values it measured, the
    context the per-layer readers read, the numbers compared with their
    limits (name → (value, limit)), the requests or steps attempted and
    failed, the set-up's parts, and the trace (``--trace 1``)."""
    end_to_end: dict
    ctx: dict
    checks: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    setup_parts: dict = field(default_factory=dict)
    trace: object = None


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, its files read."""
    root = Path(root)
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; there are {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "perfbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    limits_file = root / "perfbench" / "limits" / f"{name}.json"
    with open(limits_file) as f:
        limits = json.load(f)
    return Cell(name, w, config, traffic, limits,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)], root)


def metric_reader(name: str, root: Path = ROOT):
    """``read(ctx)`` of ``perfbench/metrics/<name>.py``."""
    path = Path(root) / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loop_module(kind: str):
    return importlib.import_module(f"perfbench.loops.{kind}")


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _number(v):
    if v is None or (isinstance(v, float) and not math.isfinite(v)):
        raise ValueError(f"not a finite number: {v!r}")
    return float(v)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, kind: str = "cpu") -> tuple:
    """Run ``cell`` and build its result line. Returns ``(result, outcome)``;
    the result is the dict printed as the last line."""
    out = loop_module(cell.traffic["loop"]).run(cell, seed, seconds, trace,
                                                device, t_start)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = metric_reader(m["name"], cell.root)(out.ctx)
            if v is not None:
                metrics[m["name"]] = {"value": _number(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] not in out.end_to_end:
                raise RuntimeError(f"the {cell.traffic['loop']} loop did not "
                                   f"measure {m['name']}")
            metrics[m["name"]] = {"value": _number(out.end_to_end[m["name"]]),
                                  "unit": m["unit"]}
    correct = (out.failed == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in out.checks.values()))
    dev = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in out.checks.items()}
    return result, out


def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = resolve(args.workload)
    import torch
    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    t_cuda = time.perf_counter()
    result, out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device, t_start, kind)
    # the parts of "imports" that vary most from host to host
    out.setup_parts["of_imports"] = {"torch": t_torch - t_start,
                                     "cuda_init": t_cuda - t_torch}
    print(json.dumps({"setup_parts": out.setup_parts}), flush=True)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 3
    for n, c in result["checks"].items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
