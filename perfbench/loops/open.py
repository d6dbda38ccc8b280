"""The open serving loop: requests due on a Poisson schedule at the mix's
``rate_per_s`` (independent users), whether or not earlier ones are done.

Set-up ends with the ramp: a prefill at each of 16 prompt lengths spread
over the mix's range (a fresh process meets each new GEMM shape of a
whole-prompt prefill for the first time), then the schedule from
``warmup_s`` seconds before the window opens. A request enters the waiting queue at the first
tick boundary at or after it is due, and is timed from when it was due,
so a stall counts against every request behind it. A request due in the
window counts toward TTFT; after the window closes nothing more is sent,
and the loop runs on until each such request has its first token.
"""
from __future__ import annotations

import time

from perfbench import traffic as gen
from perfbench.loops.serving import ServeRun, clock


def run(cell, seed, seconds, trace, device, t_start):
    R = ServeRun(cell, seed, seconds, trace, device, t_start)
    return R.finish(drive(R, cell.traffic, seed, seconds))


def drive(R, mix, seed, seconds, backlog=None):
    """The ramp, the window and its tail; returns the requests due in the
    window. ``backlog`` (a list) gets ``(time, requests waiting)`` after
    each tick of the window."""
    todo = gen.arrivals(mix, seed, R.arch.V, int(R.s["max_len"]), seconds)
    R.start_ramp()
    R.warm_prefills(mix["prompt"]["min"], mix["prompt"]["max"])
    base = clock() + float(mix["warmup_s"])     # the window's opening
    i, in_window = 0, []

    def send_due(now, until):
        nonlocal i
        while i < len(todo) and base + todo[i].due <= min(now, until):
            tr = R.send(todo[i], base + todo[i].due)
            if todo[i].due >= 0:
                in_window.append(tr)
            i += 1

    def idle_wait():
        if not R.active and i < len(todo):
            time.sleep(max(0.0, base + todo[i].due - clock()))

    while clock() < base:
        send_due(clock(), base - 1e-9)
        R.tick()
        idle_wait()
    R.open_window(base)
    while clock() < R.t1:
        send_due(clock(), R.t1)
        R.tick()
        if backlog is not None:
            backlog.append((clock() - R.t0, len(R.sched.waiting)))
        if clock() < R.t1:
            idle_wait()
    R.close_window()
    while any(tr.first is None for tr in in_window):
        R.tick()
    return in_window
