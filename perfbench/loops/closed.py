"""The closed serving loop: ``clients`` clients, each sending its next
request when its last one finishes (callers that wait for each reply).

Set-up ends with a ramp of ``warmup_ticks`` ticks. Its first round of
requests asks for a share of their outputs (a uniform share from the
seed), so that they finish at staggered times as in a running server; the
window then opens on a full batch in steady state. Each request is timed
from when it is sent; a request sent in the window counts toward TTFT,
and the loop runs on after the window closes, sending nothing, until each
such request has its first token.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np

from perfbench import traffic as gen
from perfbench.loops.serving import ServeRun, clock


def run(cell, seed, seconds, trace, device, t_start):
    mix = cell.traffic
    R = ServeRun(cell, seed, seconds, trace, device, t_start)
    reqs = itertools.cycle(gen.requests(mix, seed, R.arch.V,
                                        int(R.s["max_len"])))
    rng = np.random.default_rng([int(seed), 4])
    R.start_ramp()
    for _ in range(int(mix["clients"])):
        r = next(reqs)
        R.send(dataclasses.replace(
            r, max_new=max(1, math.ceil(r.max_new * rng.random()))), clock())
    for _ in range(int(mix["warmup_ticks"])):
        for _tr in R.tick():
            R.send(next(reqs), clock())
    R.open_window()
    in_window = []
    while clock() < R.t1:
        for _tr in R.tick():
            t = clock()
            if t < R.t1:
                in_window.append(R.send(next(reqs), t))
    R.close_window()
    while any(tr.first is None for tr in in_window):
        R.tick()
    return R.finish(in_window)
