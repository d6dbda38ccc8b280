"""What the readers of the program's own phases share.

While a profiler records, the port opens a ``repro_torch.*`` range for
each scheduler tick and each of its phases, and for each train step and
each of its phases, and keeps one record a tick of its step counters
(``repro_torch.telemetry``). The benchmark's trace of the window holds
those ranges among its host events; these functions read them:

* :func:`idle_share_in`: the device-idle gaps of the traced span that
  began inside a phase, as a share of the span. A gap goes to the
  innermost program range that covers its start, so a gap that begins
  inside a tick but between its phases goes to no phase.
* :func:`syncs_per_tick`: host synchronisations that begin inside a
  tick, over the traced ticks.
* :func:`device_ms_per_step`: device time of the work launched inside a
  phase, over the traced steps. A kernel, copy or fill goes to the range
  that holds the runtime call that launched it: the call and the device
  activity carry the same correlation id.
* :func:`tick_records`: the port's tick records that lie in the span.

Each returns None where the trace has nothing to read: a program that
opens no such range or keeps no record.
"""
from __future__ import annotations

import numpy as np
import torch

PREFIX = "repro_torch."
TICK = "repro_torch.tick"
TRAIN_STEP = "repro_torch.train.step"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def program_ranges(tr) -> list:
    """The program's ranges that overlap the traced span, each once:
    ``(start_ns, end_ns, name)``, sorted."""
    return sorted({h for h in tr.host_events
                   if h[2].startswith(PREFIX) and h[1] > tr.lo
                   and h[0] < tr.hi})


def innermost(ranges: list, times) -> list:
    """For each of the sorted ``times``, the name of the innermost range
    that covers it (``start <= t < end``), or None."""
    times = np.asarray(times, np.int64)
    names = sorted({r[2] for r in ranges})
    label = np.full(len(times), -1)
    # longest first, so that a range nested in another writes last
    for s, e, n in sorted(ranges, key=lambda r: r[0] - r[1]):
        i, j = np.searchsorted(times, [s, e])
        label[i:j] = names.index(n)
    return [names[k] if k >= 0 else None for k in label]


def idle_share_in(ctx, phase: str):
    """Device-idle gaps that began inside ``phase`` (the innermost
    program range at their start), in % of the traced span."""
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    ranges = program_ranges(tr)
    if not any(n == phase for _, _, n in ranges):
        return None
    gaps = sorted(tr.gaps)
    owner = innermost(ranges, [s for s, _ in gaps])
    idle = sum(e - s for (s, e), n in zip(gaps, owner) if n == phase)
    return 100.0 * idle * 1e-9 / tr.window_s


def syncs_per_tick(ctx):
    """Host synchronisations (``SYNCS``) that begin inside a tick, over
    the ticks in the traced span."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    ticks = [(s, e) for s, e, n in program_ranges(tr) if n == TICK]
    if not ticks:
        return None
    starts = np.array([s for s, _ in ticks], np.int64)
    ends = np.array([e for _, e in ticks], np.int64)
    calls = np.array([s for s, _, n in tr.host_events if n in SYNCS],
                     np.int64)
    k = np.searchsorted(starts, calls, side="right") - 1
    inside = (k >= 0) & (calls < ends[np.maximum(k, 0)])
    return float(inside.sum()) / len(ticks)


def _device_work(tr) -> list:
    """``(duration_ns, correlation_id)`` of every device activity in the
    traced span (the benchmark's own ranges and the program's, mirrored
    on the device's timeline, are none)."""
    out = []
    for e in tr.prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        if e.is_user_annotation() or name.startswith(("perfbench.",
                                                      PREFIX)):
            continue
        s = e.start_ns()
        if s + e.duration_ns() <= tr.lo or s >= tr.hi:
            continue
        out.append((e.duration_ns(), e.correlation_id()))
    return out


def _launches(tr) -> dict:
    """Start of each CUDA API call (``cuda*`` and ``cu*``) by its
    correlation id, the id of the device activity it launched. Host ops
    number their own ids apart, so they are left out."""
    return {e.correlation_id(): e.start_ns()
            for e in tr.prof.profiler.kineto_results.events()
            if e.device_type() != torch.autograd.DeviceType.CUDA
            and e.name().startswith("cu") and e.correlation_id()}


def device_ms_per_step(ctx, phase: str):
    """Device ms a traced train step of the work launched inside
    ``phase``."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    ranges = program_ranges(tr)
    n_steps = sum(n == TRAIN_STEP for _, _, n in ranges)
    mine = [(s, e) for s, e, n in ranges if n == phase]
    if not n_steps or not mine:
        return None
    work = _device_work(tr)
    if not work:
        return None
    launched = _launches(tr)
    found = [(launched[c], d) for d, c in work if c in launched]
    starts = np.array([t for t, _ in found], np.int64)
    durs = np.array([d for _, d in found], np.int64)
    total = sum(int(durs[(starts >= s) & (starts < e)].sum())
                for s, e in mine)
    return total * 1e-6 / n_steps


def tick_records(ctx):
    """The port's tick records that lie in the traced span, or None
    (no trace, or a program that keeps none)."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    recs = [r for r in telemetry.records()
            if r.start_ns >= tr.lo and r.end_ns <= tr.hi]
    return recs or None
