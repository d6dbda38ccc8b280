"""The device trace of a window: ``torch.profiler`` with CPU and CUDA.

:class:`Trace` starts the profiler with the window open (inside a span of
the benchmark's own, ``perfbench.window``), stops it, and reduces the raw
events to what the metrics read: the device's busy seconds (the union of
every device activity inside the span), the traced span's length, the
device seconds of kernels by name, and the 500 longest idle gaps summed
by what the host was doing when each began (the shortest host event that
covers the gap's start: an op, a runtime call or a span of ours).
"""
from __future__ import annotations

import torch

WINDOW_SPAN = "perfbench.window"
SPAN_SECONDS = 8.0     # a traced run traces its window's last 8 seconds


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


class Trace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.span = None

    @staticmethod
    def warm():
        """Start and stop the profiler once over nothing, in set-up, so
        that the traced span's start pays no first-use cost."""
        t = Trace()
        t.prof.__enter__()
        torch.zeros(1).add_(1)
        t.prof.__exit__(None, None, None)

    def start(self):
        self.prof.__enter__()
        self.span = torch.profiler.record_function(WINDOW_SPAN)
        self.span.__enter__()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self._reduce()

    def _reduce(self):
        dev, host, lo, hi = [], [], None, None
        for e in self.prof.profiler.kineto_results.events():
            s = _ns(e, "start")
            end = s + _ns(e, "duration")
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # a span of ours mirrored on the device's timeline is no
                # device activity
                if not (e.is_user_annotation()
                        or e.name().startswith("perfbench.")):
                    dev.append((s, end, e.name()))
            else:
                host.append((s, end, e.name()))
                if e.name() == WINDOW_SPAN:
                    lo, hi = s, end
        if lo is None:
            raise RuntimeError("the trace has no window span")
        self.lo, self.hi = lo, hi
        self.window_s = (hi - lo) * 1e-9
        clipped = sorted((max(s, lo), min(e, hi), n) for s, e, n in dev
                         if e > lo and s < hi)
        self.kernels: dict = {}
        busy, gaps, cur_end = 0, [], lo
        for s, e, n in clipped:
            self.kernels[n] = self.kernels.get(n, 0.0) + (e - s) * 1e-9
            if s > cur_end:
                gaps.append((cur_end, s))
            if e > cur_end:
                busy += e - max(s, cur_end)
                cur_end = e
        if hi > cur_end:
            gaps.append((cur_end, hi))
        self.busy_s = busy * 1e-9
        self.host_events = host
        self.gaps = gaps

    def device_s(self, *patterns, exclude=()) -> float:
        """Device seconds of the kernels whose names hold one of
        ``patterns`` and none of ``exclude``."""
        return sum(t for n, t in self.kernels.items()
                   if any(p in n for p in patterns)
                   and not any(x in n for x in exclude))

    def breakdown(self, top: int = 10) -> dict:
        import numpy as np
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:top]
        longest = sorted(self.gaps, key=lambda g: g[0] - g[1])[:500]
        host = [h for h in self.host_events if h[2] != WINDOW_SPAN]
        hs = np.array([h[0] for h in host], np.int64)
        he = np.array([h[1] for h in host], np.int64)
        named: dict = {}
        for s, e in longest:
            cover = np.flatnonzero((hs <= s) & (he > s))
            key = (host[cover[np.argmin((he - hs)[cover])]][2]
                   if len(cover) else "(no host event)")
            named[key] = named.get(key, 0.0) + (e - s) * 1e-9
        idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], t] for n, t in ops],
                "idle_gaps": [[n[:120], t] for n, t in idle]}
