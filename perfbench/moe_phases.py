"""What the readers of a drop-free MoE model's work share.

While a profiler records, each drop-free MoE layer of the port opens the
ranges ``repro_torch.moe.route``, ``.experts`` and ``.shared``, and each
scheduler tick leaves a record whose ``expert_rows``, ``routed_slots`` and
``experts_run`` are what the tick's forwards computed (0-d tensors on the
card, read here, after the window). Each function returns None where the
trace has nothing to read: a program that opens no such range or keeps
no such counter.
"""
from __future__ import annotations

import numpy as np

from perfbench import moe_counts, phases

MOE = "repro_torch.moe."
EXPERTS = "repro_torch.moe.experts"


def records(ctx):
    """The traced span's tick records, if they carry the MoE counters."""
    recs = phases.tick_records(ctx)
    if not recs or getattr(recs[0], "expert_rows", None) is None:
        return None
    return recs


def _inside(times, spans) -> np.ndarray:
    """Which of ``times`` lie in one of the disjoint ``spans``."""
    if not spans:
        return np.zeros(len(times), bool)
    spans = sorted(spans)
    lo = np.array([s for s, _ in spans], np.int64)
    hi = np.array([e for _, e in spans], np.int64)
    k = np.searchsorted(lo, times, side="right") - 1
    return (k >= 0) & (times < hi[np.maximum(k, 0)])


def device_s_in(ctx, name: str):
    """Device seconds of the work launched inside the program's ranges
    named ``name`` (a name ending in ``.``: every range under it) during
    the traced span's tick records. A kernel, copy or fill goes to the
    range that holds the runtime call that launched it (the same
    correlation id)."""
    recs = records(ctx)
    if recs is None:
        return None
    tr = ctx["trace"]
    mine = [(s, e) for s, e, n in phases.program_ranges(tr)
            if (n.startswith(name) if name.endswith(".") else n == name)]
    if not mine:
        return None
    launched = phases._launches(tr)
    found = [(launched[c], d) for d, c in phases._device_work(tr)
             if c in launched]
    if not found:
        return None
    t = np.array([s for s, _ in found], np.int64)
    d = np.array([x for _, x in found], np.int64)
    keep = _inside(t, mine) & _inside(t, [(r.start_ns, r.end_ns)
                                          for r in recs])
    return float(d[keep].sum()) * 1e-9


def expert_roofline(ctx):
    """The held experts' least time over the traced ticks (each tick's
    rows and experts given work, :func:`perfbench.moe_counts.
    expert_bound_s`) over the device time launched inside
    ``repro_torch.moe.experts``, in %."""
    recs, dev = records(ctx), device_s_in(ctx, EXPERTS)
    if recs is None or not dev:
        return None
    a = ctx["arch"]
    bound = sum(moe_counts.expert_bound_s(int(r.expert_rows),
                                          int(r.experts_run), a)
                for r in recs)
    return 100.0 * bound / dev if bound else None
