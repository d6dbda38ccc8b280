"""The port's phases on the profiler's timeline (``repro_torch.telemetry``).

At smoke widths on the CPU: under ``torch.profiler.profile`` a scheduler
tick is a ``repro_torch.tick`` range with its five phase ranges inside it,
and leaves one tick record whose bounds lie on that range; the engine's
step counters equal a count made from the rows handed to ``step_batch``
and the logits the model returned; with no profiler nothing is recorded;
a train step is a ``repro_torch.train.step`` range holding its forward,
backward and optimizer ranges.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import telemetry
from repro_torch.configs import get_config
from repro_torch.core.engines import EngineSpec
from repro_torch.models import LM
from repro_torch.serving import Request, Scheduler, ServeConfig, ServingEngine
from repro_torch.training import AdamWConfig, init_train_state, make_train_step

ARCH = "internlm2-1.8b-smoke"
PHASES = {telemetry.ADMIT, telemetry.PLAN, telemetry.PREPARE,
          telemetry.FORWARD, telemetry.COMMIT}
TRAIN_PHASES = {telemetry.TRAIN_FORWARD, telemetry.TRAIN_BACKWARD,
                telemetry.TRAIN_OPTIMIZER}
SLACK_NS = 50_000


@pytest.fixture(autouse=True)
def no_records_and_one_thread():
    telemetry.clear()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    telemetry.clear()


@pytest.fixture(scope="module")
def model():
    return LM(get_config(ARCH), device="cpu").init(
        torch.Generator().manual_seed(0))


def scheduler(model):
    """Three requests on a pooled paged engine, prefilled in 5-token
    chunks, so that ticks mix chunk rows with decode rows."""
    eng = ServingEngine(model, ServeConfig(
        max_len=48, page_tokens=4, max_batch_seqs=4, prefill_chunk_tokens=5,
        engine_spec=EngineSpec(engine="paged")), device="cpu")
    assert eng.pooled and eng.fused
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, max_new=6, prompt=rng.integers(
        0, model.cfg.vocab_size, n).astype(np.int32))
        for i, n in enumerate((8, 12, 13))]
    return Scheduler(eng, reqs)


def program_ranges(prof):
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("repro_torch."))


def within(rs, s, e):
    return {n for s2, e2, n in rs if s <= s2 and e2 <= e}


def test_tick_holds_its_phases_and_one_record(model):
    sched = scheduler(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the profiler's first range in a session pays a first-use cost
        # (~1 ms here); a caller's own outer range takes it, as the
        # benchmark's window span does
        with torch.profiler.record_function("outer"):
            for _ in range(3):
                sched.tick()
    rs = program_ranges(prof)
    ticks = [r for r in rs if r[2] == telemetry.TICK]
    assert len(ticks) == 3
    for s, e, _ in ticks:
        assert within(rs, s, e) - {telemetry.TICK} == PHASES
    # no phase outside a tick
    assert all(any(s <= r[0] and r[1] <= e for s, e, _ in ticks)
               for r in rs)
    recs = telemetry.records()
    assert len(recs) == 3
    for r, (s, e, _) in zip(recs, ticks):
        assert r.start_ns <= r.end_ns
        assert abs(r.start_ns - s) <= SLACK_NS
        assert abs(r.end_ns - e) <= SLACK_NS


def test_step_counters_match_the_rows_stepped(model):
    """``step_slots``, ``step_tokens`` and ``logit_bytes``, counted by the
    engine and summed over the tick records, against the rows each
    ``step_batch`` got (padded up the power-of-two ladder here) and the
    logits each admission's prefill returned."""
    sched = scheduler(model)
    eng = sched.engine
    step, prefill = eng.step_batch, eng.prefill_one
    want = {"step_slots": 0, "step_tokens": 0, "logit_bytes": 0}

    def pow2(n):
        return 1 << (n - 1).bit_length()

    def step_spy(rids, caches, tok_rows, *a, **k):
        out = step(rids, caches, tok_rows, *a, **k)
        q = [len(t) for t in tok_rows]
        slots = pow2(len(q)) * pow2(max(q))
        row = out[0][0]
        want["step_slots"] += slots
        want["step_tokens"] += sum(q)
        want["logit_bytes"] += slots * row.shape[-1] * row.element_size()
        return out

    def prefill_spy(*a, **k):
        logits, cache = prefill(*a, **k)
        want["logit_bytes"] += logits.numel() * logits.element_size()
        return logits, cache

    eng.step_batch, eng.prefill_one = step_spy, prefill_spy
    with profile(activities=[ProfilerActivity.CPU]):
        sched.run()
    assert want["step_slots"] > want["step_tokens"] > 0
    assert {k: eng.step_stats[k] for k in want} == want
    recs = telemetry.records()
    assert len(recs) == sched.stats.ticks
    for k in want:
        assert sum(getattr(r, k) for r in recs) == want[k], k
    assert sum(r.decode_rows for r in recs) == sched.stats.decode_rows
    assert sum(r.prefill_chunks for r in recs) == sched.stats.prefill_chunks


def test_nothing_is_recorded_without_a_profiler(model):
    sched = scheduler(model)
    sched.run()
    assert sched.stats.ticks > 0 and sched.engine.step_stats["step_slots"]
    assert telemetry.records() == []
    assert telemetry.span(telemetry.TICK) is telemetry.span(telemetry.PLAN)


def test_train_step_holds_its_phases():
    cfg = get_config(ARCH)
    m = LM(cfg, device="cpu")
    state = init_train_state(m, torch.Generator().manual_seed(0))
    step = make_train_step(m, AdamWConfig(lr=1e-3, warmup_steps=1,
                                          total_steps=10))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 17))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state, _ = step(state, batch)
    rs = program_ranges(prof)
    steps = [r for r in rs if r[2] == telemetry.TRAIN_STEP]
    assert len(steps) == 2
    for s, e, _ in steps:
        assert within(rs, s, e) - {telemetry.TRAIN_STEP} == TRAIN_PHASES
    assert int(state.step) == 2
    assert telemetry.records() == []
