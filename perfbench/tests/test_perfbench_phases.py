"""The readers of the program's phases (``perfbench/phases.py`` and the
metrics on it), on synthetic traces worked out by hand: a gap goes to the
innermost program range at its start, the phases' idle never passes the
whole idle share, device time goes to the phase that launched it through
the correlation ids, and a trace with no program ranges (a program
without them) gives no number and no error."""
import numpy as np
import pytest
import torch

from perfbench import phases, readers
from perfbench.bench import load_benchmark, metric_reader

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
NEW = ["idle_admit.serve", "idle_plan.serve", "idle_prepare.serve",
       "idle_forward.serve", "idle_commit.serve", "syncs_per_tick.serve",
       "slot_use.serve", "logit_mib_per_tick.serve", "idle_admit.ttft",
       "idle_forward.ttft", "forward_ms.train", "backward_ms.train",
       "optimizer_ms.train"]


class Ev:
    """A profiler event, as much of one as the readers ask of it."""

    def __init__(self, name, start, dur, corr=0, device=CPU, annot=False):
        self._n, self._s, self._d, self._c = name, start, dur, corr
        self._dev, self._a = device, annot

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._a


class FakeTrace:
    """What ``perfbench.trace.Trace`` leaves after ``stop()``: the span
    ``[lo, hi)``, its host events, its idle gaps, the raw events."""

    def __init__(self, lo, hi, events):
        self.lo, self.hi, self.window_s = lo, hi, (hi - lo) * 1e-9
        self.host_events = [(e.start_ns(), e.start_ns() + e.duration_ns(),
                             e.name()) for e in events
                            if e.device_type() != CUDA]
        dev = sorted((max(e.start_ns(), lo),
                      min(e.start_ns() + e.duration_ns(), hi))
                     for e in events if e.device_type() == CUDA
                     and not e.is_user_annotation()
                     and e.start_ns() + e.duration_ns() > lo
                     and e.start_ns() < hi)
        self.gaps, cur, busy = [], lo, 0
        for s, e in dev:
            if s > cur:
                self.gaps.append((cur, s))
            if e > cur:
                busy += e - max(s, cur)
                cur = e
        if hi > cur:
            self.gaps.append((cur, hi))
        self.busy_s = busy * 1e-9
        raw = list(events)
        self.prof = type("P", (), {"profiler": type("K", (), {
            "kineto_results": type("R", (), {
                "events": staticmethod(lambda: raw)})()})()})()


def kernel(start, dur, corr=0):
    return Ev("k", start, dur, corr, CUDA)


def tick_trace():
    """One tick [100, 1100): admit [100, 300), plan [300, 400), forward
    [400, 900) nested in the tick; kernels leave gaps that begin in
    admit (150), between phases (900: the tick alone), in forward (450,
    700) and after the tick (1150)."""
    ev = [Ev("repro_torch.tick", 100, 1000),
          Ev("repro_torch.tick.admit", 100, 200),
          Ev("repro_torch.tick.plan", 300, 100),
          Ev("repro_torch.tick.forward", 400, 500),
          Ev("repro_torch.tick.forward", 400, 500, device=CUDA,
             annot=True),
          Ev("aten::mm", 420, 20),
          kernel(0, 150), kernel(200, 250), kernel(500, 200),
          kernel(750, 150), kernel(950, 200), kernel(1200, 800)]
    return FakeTrace(0, 2000, ev)


def test_gaps_go_to_the_innermost_range():
    ctx = {"trace": tick_trace()}
    # gaps: (150, 200) admit, (450, 500) and (700, 750) forward, (900,
    # 950) the tick only, (1150, 1200) no range
    assert phases.idle_share_in(ctx, "repro_torch.tick.admit") == \
        pytest.approx(100 * 50 / 2000)
    assert phases.idle_share_in(ctx, "repro_torch.tick.forward") == \
        pytest.approx(100 * 100 / 2000)
    assert phases.idle_share_in(ctx, "repro_torch.tick.plan") == 0.0
    assert phases.idle_share_in(ctx, "repro_torch.tick.commit") is None
    assert readers.idle_share(ctx) == pytest.approx(100 * 250 / 2000)


@pytest.mark.parametrize("seed", range(4))
def test_phases_never_pass_the_idle_share(seed):
    """Random ticks of random phases over random kernels: the phases'
    idle sums to at most the whole idle share, and to all of it when
    every gap begins in a phase."""
    rng = np.random.default_rng(seed)
    names = ["admit", "plan", "prepare", "forward", "commit"]
    ev, t = [], 0
    for _ in range(20):
        cuts = np.sort(rng.integers(1, 1000, len(names) - 1))
        bounds = [0, *cuts, 1000]
        ev.append(Ev("repro_torch.tick", t, 1000))
        for n, a, b in zip(names, bounds, bounds[1:]):
            if b > a:
                ev.append(Ev("repro_torch.tick." + n, t + a, b - a))
        t += 1000
    starts = np.sort(rng.choice(t, 300, replace=False))
    ev += [kernel(int(s), int(rng.integers(1, 60))) for s in starts]
    ctx = {"trace": FakeTrace(0, t, ev)}
    parts = [phases.idle_share_in(ctx, "repro_torch.tick." + n) or 0.0
             for n in names]
    assert sum(parts) <= readers.idle_share(ctx) + 1e-9
    assert sum(parts) == pytest.approx(readers.idle_share(ctx))


def test_syncs_count_inside_ticks_only():
    ev = [Ev("repro_torch.tick", 0, 100), Ev("repro_torch.tick", 200, 100),
          Ev("cudaStreamSynchronize", 10, 5),
          Ev("cudaStreamSynchronize", 250, 5),
          Ev("cudaEventSynchronize", 260, 5),
          Ev("cudaStreamSynchronize", 150, 5),      # between ticks
          Ev("cudaLaunchKernel", 20, 5), kernel(30, 40)]
    ctx = {"trace": FakeTrace(0, 400, ev)}
    assert phases.syncs_per_tick(ctx) == 1.5
    assert metric_reader("syncs_per_tick.serve")(ctx) == 1.5


def train_trace():
    """Two steps of [0, 1000): forward [0, 300), backward [300, 800),
    optimizer [800, 950). Each launch's kernel runs 400 ns after it, in
    another phase's time; a host op that shares a kernel's id number (its
    own numbering) and the device copy of a range count for nothing."""
    ev = []
    for base in (0, 1000):
        ev += [Ev("repro_torch.train.step", base, 1000),
               Ev("repro_torch.train.forward", base, 300),
               Ev("repro_torch.train.backward", base + 300, 500),
               Ev("repro_torch.train.optimizer", base + 800, 150),
               Ev("repro_torch.train.backward", base + 300, 500,
                  device=CUDA, annot=True)]
        for k, (t, dur) in enumerate([(100, 30), (250, 20), (400, 200),
                                      (850, 40)]):
            corr = base + k + 1
            ev += [Ev("cudaLaunchKernel", base + t, 5, corr),
                   kernel(base + t + 400, dur, corr)]
        ev.append(Ev("aten::mm", base + 900, 10, base + 1))
    return FakeTrace(0, 2400, ev)


def test_device_time_goes_to_the_launching_phase():
    ctx = {"trace": train_trace()}
    assert phases.device_ms_per_step(ctx, "repro_torch.train.forward") == \
        pytest.approx(50e-6)
    assert metric_reader("backward_ms.train")(ctx) == pytest.approx(200e-6)
    assert metric_reader("optimizer_ms.train")(ctx) == pytest.approx(40e-6)


def test_tick_records_inside_the_span():
    from repro_torch import telemetry
    telemetry.clear()
    try:
        before = (0, 0, 0, 0, 0)
        for start, slots, toks in ((50, 64, 8), (150, 256, 100),
                                   (250, 64, 64)):
            telemetry.record_tick(start, start + 50, before,
                                  (slots, toks, 2 ** 20 * slots, 1, 0))
        ctx = {"trace": FakeTrace(100, 400, [kernel(100, 10)])}
        assert len(phases.tick_records(ctx)) == 2
        assert metric_reader("slot_use.serve")(ctx) == \
            pytest.approx(100 * 164 / 320)
        assert metric_reader("logit_mib_per_tick.serve")(ctx) == \
            pytest.approx(160.0)
    finally:
        telemetry.clear()


@pytest.mark.parametrize("name", NEW)
def test_no_program_ranges_no_number(name):
    """A traced run of a program that opens no ``repro_torch.*`` range
    and keeps no record: each new reader finds nothing and says so."""
    from repro_torch import telemetry
    telemetry.clear()
    ev = [Ev("perfbench.tick", 0, 500), Ev("cudaStreamSynchronize", 10, 5),
          Ev("cudaLaunchKernel", 20, 5, 1), kernel(30, 40, 1)]
    assert metric_reader(name)({"trace": FakeTrace(0, 1000, ev)}) is None
    assert metric_reader(name)({"trace": None}) is None


def test_each_new_metric_has_its_entry():
    per_layer = {m["name"]: m for m in load_benchmark()["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert len(m["workloads"]) == 1
        assert m["moves"] in ("serve_tok_s", "ttft_p90_ms", "train_tok_s")
