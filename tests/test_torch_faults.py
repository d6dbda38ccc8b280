"""The port's fault injection and token journal against the JAX package's.

* the injector: every decision — transfer fail/delay, seeded page loss
  with its per-page generation, armed losses, scripted tick events,
  crashes — equals the JAX injector's over a grid of keys, and ``_u01``
  is the same blake2b draw;
* the journal: round trip, idempotent replay, gap rejection, snapshot
  compaction and a torn tail give JAX's replayed state and stats from the
  same WAL bytes, and the NVMM charges on the simulated clock equal JAX's;
* serving, for the dense, int8 and MLA families: an unfused run on a
  tight pool spills pages of running rows and faults them back; with
  ``page_loss_rate > 0`` (and transfer faults on the async pipeline) a
  lost page sheds its row, and the tokens stay those of the fault-free
  run and the JAX engine's, with the same fault counters;
* a crash at a tick boundary recovers through a fresh engine that shares
  the journal, to the uninterrupted tokens, as in the JAX engine; a
  poisoned tick leaks no pool page;
* one hypothesis property: family × ``speculate_k`` ∈ {0, 2} × prefix
  sharing × crash tick, against the uninterrupted run.
"""
import pytest

from repro.core import SimClock as JaxSimClock
from repro.serving import faults as jax_faults
from repro.serving.journal import ServingJournal as JaxServingJournal
from repro_torch.core import SimClock
from repro_torch.serving import faults
from repro_torch.serving.journal import ServingJournal

from torch_serving_pairs import (FAMILIES, Side, assert_counters_equal, pair,
                                 prompts, tokens)
from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)

FAMS = list(FAMILIES)
FAULT_KEYS = ("host_pages_lost", "transfer_retries", "transfer_failures",
              "retried_faults", "shard_stalls", "tiering_degraded",
              "sched_rows_shed", "sched_degraded_ticks")


# ---------------------------------------------------------------- injector
def test_u01_is_the_jax_draw():
    for parts in [(0, "xfail", ("d2h", 1, 2), 0), (7, "plost", 3, 1, 2),
                  (123, "xdelay", ("h2d", 0, 0))]:
        assert faults._u01(*parts) == jax_faults._u01(*parts)


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_injector_decisions_match_jax(seed):
    """A grid of transfer keys and attempts, seeded page losses (a lost
    page re-rolls with its next generation), armed losses and a script:
    the same answers and the same tallies as the JAX injector."""
    kw = dict(seed=seed, transfer_fail_rate=0.3, transfer_delay_rate=0.3,
              page_loss_rate=0.4, crash_at_tick=4)
    script = [(2, "shard_stall", 1, 0.5), (3, "page_lost", (0, 0), None),
              (5, "crash", None, None)]
    injs = []
    for mod in (jax_faults, faults):
        plan = mod.FaultPlan(script=tuple(mod.FaultEvent(*e) for e in script),
                             **kw)
        injs.append(mod.FaultInjector(plan))
    answers = [[], []]
    for ans, inj in zip(answers, injs):
        for d in ("d2h", "h2d"):
            for s in range(4):
                for lg in range(4):
                    for att in range(3):
                        ans.append(inj.transfer_fails((d, s, lg), att))
                    ans.append(inj.transfer_delay((d, s, lg)))
        for _ in range(3):
            ans += [inj.page_lost(s, lg) for s in range(4) for lg in range(3)]
        inj.arm_page_loss((9, 1))
        inj.arm_page_loss(8)
        ans += [inj.page_lost(9, 1), inj.page_lost(9, 1), inj.page_lost(8, 5)]
        for tick in range(1, 7):
            ans.append([(e.tick, e.kind, e.key, e.value)
                        for e in inj.begin_tick(tick)])
            ans.append(inj.crash_now(tick))
    assert answers[0] == answers[1]
    assert injs[0].counts == injs[1].counts and injs[1].injected() > 0


# ----------------------------------------------------------------- journal
def _journal_ops(j, case):
    """Drive one journal through ``case``; returns what a caller sees."""
    out = []
    if case == "round_trip":
        j.append_tick(1, [(0, 0, [11, 12])])
        j.append_tick(2, [(0, 2, [13]), (1, 0, [21])])
        out += [j.replay(), j.committed(0), j.committed(9)]
    elif case == "idempotent":
        j.append_tick(1, [(0, 0, [1, 2])])
        j.append_tick(2, [(0, 2, [3])])
        out += [j.replay(), j.replay()]
        j.append_tick(3, [(0, 1, [2, 3])])
        out.append(j.replay())
    elif case == "gap":
        j.append_tick(1, [(0, 0, [1])])
        with pytest.raises(ValueError, match="journal gap"):
            j.append_tick(2, [(0, 5, [9])])
        out.append(j.replay())
    elif case == "compaction":
        want: dict = {}
        for tick in range(1, 60):
            rid = tick % 3
            start = len(want.setdefault(rid, []))
            want[rid][start:start + 2] = [tick, tick + 1]
            j.append_tick(tick, [(rid, start, [tick, tick + 1])])
        out += [j.replay(), want]
    else:                                          # torn tail
        for t in (1, 2, 3):
            j.append_tick(t, [(0, t - 1, [t])])
        j.wal.buf[(j.wal.head - 1) % j.wal.capacity] ^= 0xFF
        out.append(j.replay())
    return out, dict(j.stats), bytes(j.wal.buf)


@pytest.mark.parametrize("case", ["round_trip", "idempotent", "gap",
                                  "compaction", "torn_tail"])
def test_journal_matches_jax(case):
    cap = 512 if case == "compaction" else 1 << 12
    got = _journal_ops(ServingJournal(capacity=cap), case)
    want = _journal_ops(JaxServingJournal(capacity=cap), case)
    assert got == want
    if case == "compaction":
        assert got[1]["journal_compactions"] > 0
        assert got[0][0] == (got[0][1], 59)
    if case == "torn_tail":
        assert got[0][0] == ({0: [1, 2]}, 2)


def test_journal_nvmm_charges_match_jax():
    """The append is a sequential NVMM write on the foreground clock:
    the same bytes and the same time as the JAX journal's."""
    clocks = []
    for journal, clock in ((ServingJournal, SimClock()),
                           (JaxServingJournal, JaxSimClock())):
        j = journal(capacity=1 << 12, clock=clock)
        for t in range(1, 40):
            j.append_tick(t, [(t % 2, len(j.committed(t % 2)),
                               [t, t + 1, t + 2])])
        clocks.append((clock.now, clock.bytes_moved("nvmm", "write"),
                       j.stats["journal_bytes"]))
        quiet = journal(capacity=1 << 12, clock=clock, charge_clock=False)
        quiet.append_tick(1, [(0, 0, [5])])
        assert clock.now == clocks[-1][0]      # accounting-free mode
    assert clocks[0][1] == clocks[0][2] == clocks[1][1]
    assert clocks[0][0] == pytest.approx(clocks[1][0], rel=1e-12)
    assert clocks[0][0] > 0.0


# ----------------------------------------------------------------- serving
LOSSY_LENS = (30, 9, 27, 6)
LOSSY_NEW = 6


def _lossy_engine(side, plan=None):
    """Unfused ticks (chunks extend through the decode entry with only
    their own row pinned) on a 14-page pool with 6-token chunks: pages of
    running rows spill to the host and fault back."""
    return side.engine(pages=14, chunk=6, fuse=False, max_batch_seqs=2,
                       plan=plan, async_tiering=True)


def lossy(side):
    plan = side.plan(seed=3, page_loss_rate=1.0, transfer_fail_rate=0.3,
                     transfer_delay_rate=0.3,
                     script=[(2, "shard_stall", 1, 1e-3)])
    eng = _lossy_engine(side, plan)
    reqs = side.requests(prompts(0, LOSSY_LENS), LOSSY_NEW)
    eng.generate(reqs)
    return {"tokens": tokens(reqs), "stats": eng.stats(),
            "counts": dict(eng.injector.counts)}


@pytest.mark.parametrize("fam", FAMS)
def test_lost_page_sheds_its_row_like_jax(fam):
    """Every spilled page comes back lost: its row sheds to the front of
    waiting and re-prefills ``prompt + generated``; the streams stay the
    fault-free run's and JAX's, and every fault counter equals JAX's."""
    want, got = pair(fam, lossy)
    side = Side("torch", fam)
    ref = side.requests(prompts(0, LOSSY_LENS), LOSSY_NEW)
    clean = _lossy_engine(side)
    clean.generate(ref)
    assert clean.stats()["pool_faults"] > 0    # spilled pages came back
    s = got["stats"]
    assert s["host_pages_lost"] >= 1 and s["sched_rows_shed"] >= 1
    assert s["transfer_retries"] > 0
    assert got["tokens"] == tokens(ref) == want["tokens"]
    assert got["counts"] == want["counts"]
    assert_counters_equal(s, want["stats"])
    for key in FAULT_KEYS:
        assert s[key] == want["stats"][key], key


CRASH_LENS = (6, 9, 7)


def crash(side):
    """A journaled run crashed by a scripted event at tick 3, then a fresh
    engine sharing the journal recovers the same requests."""
    journal = side.journal()
    eng = side.engine(journal=journal, k=2, prefix_tokens=4096,
                      plan=side.plan(script=[(3, "crash", None, None)]),
                      max_batch_seqs=2)
    reqs = side.requests(prompts(1, CRASH_LENS), 5)
    with pytest.raises(side.faults.CrashFault):
        eng.generate(reqs)
    crashed = journal.replay()
    eng2 = side.engine(journal=journal, k=2, prefix_tokens=4096,
                       max_batch_seqs=2)
    again = side.requests(prompts(1, CRASH_LENS), 5)
    eng2.recover(again)
    return {"crashed": crashed, "tokens": tokens(again),
            "stats": eng2.stats(), "final": journal.replay()}


@pytest.mark.parametrize("fam", FAMS)
def test_crash_recovers_uninterrupted_tokens_like_jax(fam):
    """The journal holds the same durable commits at the crash as JAX's;
    the recovered streams equal the uninterrupted run's and JAX's, and the
    journal's final state is the whole stream."""
    want, got = pair(fam, crash)
    side = Side("torch", fam)
    ref = side.requests(prompts(1, CRASH_LENS), 5)
    side.engine(k=2, prefix_tokens=4096, max_batch_seqs=2).generate(ref)
    state, tick = got["crashed"]
    assert tick == 3 and any(0 < len(t) < 5 for t in state.values())
    assert got["crashed"] == want["crashed"]
    assert got["tokens"] == tokens(ref) == want["tokens"]
    assert got["final"][0] == {r.rid: list(r.generated) for r in ref}
    assert_counters_equal(got["stats"], want["stats"])
    for key in ("journal_appends", "journal_bytes", "journal_compactions"):
        assert got["stats"][key] == want["stats"][key], key


def test_poisoned_tick_leaves_no_pinned_pool_pages():
    """An exception between ``prepare_step`` and ``commit_step`` inside a
    fused tick leaves the pool exactly free + live + idle-index pages."""
    side = Side("torch", "dense")
    eng = side.engine(prefix_tokens=4096)
    real = eng.tiered.commit_step_planes
    calls = {"n": 0}

    def poisoned(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("poisoned tick")
        return real(*a, **kw)
    eng.tiered.commit_step_planes = poisoned
    with pytest.raises(RuntimeError, match="poisoned tick"):
        eng.generate(side.requests(prompts(1, CRASH_LENS), 4))
    kv = eng.tiered
    live = {p for tbl in kv.block_table.values() for p in tbl if p >= 0}
    assert len(kv.free_pages) + len(live) + kv._idle_index_pages() \
        == kv.pool_pages
    assert calls["n"] == 2


# ---------------------------------------------------------------- property
_REF: dict = {}


def _reference(fam, share):
    """The uninterrupted run without speculation (prefix sharing as
    asked: an int8 tail spliced onto a cached prefix attends quantized
    K/V, another function than one-shot prefill)."""
    if (fam, share) not in _REF:
        side = Side("torch", fam)
        reqs = side.requests(prompts(2, CRASH_LENS + (9,)), 5)
        side.engine(prefix_tokens=4096 * share,
                    max_batch_seqs=2).generate(reqs)
        _REF[fam, share] = tokens(reqs)
    return _REF[fam, share]


def test_features_compose_to_the_uninterrupted_stream():
    """Family × ``speculate_k`` ∈ {0, 2} × prefix sharing × crash tick:
    a journaled run, crashed at the drawn tick (or not at all) and
    recovered by a fresh engine, gives the uninterrupted tokens."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=10, deadline=None, derandomize=True)
    @hyp.given(fam=st.sampled_from(FAMS), k=st.sampled_from([0, 2]),
               share=st.booleans(),
               crash_at=st.one_of(st.none(), st.integers(1, 6)))
    def prop(fam, k, share, crash_at):
        side = Side("torch", fam)
        journal = side.journal()
        kw = dict(k=k, prefix_tokens=4096 * share, journal=journal,
                  max_batch_seqs=2)
        ps = prompts(2, CRASH_LENS + (9,))
        reqs = side.requests(ps, 5)
        plan = (None if crash_at is None else
                side.plan(script=[(crash_at, "crash", None, None)]))
        try:
            side.engine(plan=plan, **kw).generate(reqs)
        except faults.CrashFault:
            reqs = side.requests(ps, 5)
            side.engine(**kw).recover(reqs)
        assert tokens(reqs) == _reference(fam, share)
    prop()
