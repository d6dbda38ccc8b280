"""The port's speculative decode against the JAX package's.

* ``NGramProposer`` proposes what the JAX proposer proposes on seeded
  random streams (incremental ingest, a diverging stream, ``drop``);
* the acceptance edges — drafts wrong from the first, wrong in the middle,
  never wrong — give the tokens of the run without speculation and JAX's
  tokens and counters (``spec_proposed``/``spec_accepted`` included), for
  the dense, int8 and MLA families;
* rollback: an always-wrong proposer on a tight pool leaves no stranded
  page user and ``pool == free + idle-index`` pages, with byte counters
  that stay the exact bytes-moved record;
* composition: speculation across preemption (counters equal JAX's after
  every tick, and monotone), and speculation after a prefix splice;
* launch economy: a fused tick with drafts is ONE ragged attention call a
  layer, at Qmax ``bucket(1 + k)``.
"""
import numpy as np
import pytest

import repro_torch.models.attention as attention
from repro.serving import NGramProposer as JaxNGramProposer
from repro.serving import Scheduler as JaxScheduler
from repro_torch.serving import NGramProposer, Scheduler

from torch_serving_pairs import (COUNTERS, FAMILIES, MAX_LEN, PAGE_TOKENS,
                                 Side, assert_counters_equal, models, pair,
                                 prompts, tokens)
from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)

FAMS = list(FAMILIES)
LENS = (8, 12, 8)
PRESSURE_LENS = (12, 16, 12)
MAX_NEW = 6
K = 4
_TRUTH: dict = {}


class OracleProposer:
    """Scripted drafts from the known greedy continuation: the TRUE next
    tokens, each draft at or past ``wrong_at`` corrupted (None = never).
    ``wrong_at=0`` rejects every draft, ``wrong_at=j`` forces a rejection
    after exactly ``j`` accepted drafts."""

    def __init__(self, truth: dict, wrong_at=None, vocab=512):
        self.truth, self.wrong_at, self.vocab = truth, wrong_at, vocab

    def propose(self, seq, tokens, k):
        full = self.truth[seq]
        out = []
        for j in range(k):
            if len(tokens) + j >= len(full):
                break
            t = int(full[len(tokens) + j])
            if self.wrong_at is not None and j >= self.wrong_at:
                t = (t + 1) % self.vocab
            out.append(t)
        return out

    def drop(self, seq):
        pass


def truth(fam, ps, prefix_tokens=0):
    """rid → prompt + greedy tokens of the port's run without speculation
    (the JAX engine's tokens: ``tests/test_torch_families.py``)."""
    key = (fam, tuple(map(tuple, ps)), prefix_tokens)
    if key not in _TRUTH:
        side = Side("torch", fam)
        reqs = side.requests(ps, MAX_NEW)
        side.engine(prefix_tokens=prefix_tokens).generate(reqs)
        _TRUTH[key] = {r.rid: [int(t) for t in r.prompt] + list(r.generated)
                       for r in reqs}
    return _TRUTH[key]


def _plain(t):
    return [v[-MAX_NEW:] for v in t.values()]


# ----------------------------------------------------------------- proposer
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_proposer_matches_jax(seed):
    """Growing streams over a four-letter alphabet, a diverging rewrite
    and a ``drop``: every proposal equals the JAX proposer's."""
    rng = np.random.default_rng(seed)
    mine, ref = NGramProposer(max_n=3), JaxNGramProposer(max_n=3)
    streams = {s: [int(t) for t in rng.integers(0, 4, 40)] for s in range(3)}
    for step in range(60):
        seq = int(rng.integers(0, 3))
        n = int(rng.integers(1, 41))
        toks = streams[seq][:n]
        if step == 30:                       # a diverging stream rebuilds
            toks = toks[:-1] + [9]
        k = int(rng.integers(0, 6))
        assert mine.propose(seq, toks, k) == ref.propose(seq, toks, k)
        if step % 17 == 16:
            mine.drop(seq)
            ref.drop(seq)
    assert mine.propose(0, [1, 2, 3, 1, 2, 3], 4) == [1, 2, 3, 1]


# --------------------------------------------------------- acceptance edges
def _edge(wrong_at):
    def scenario(side):
        ps = prompts(0, LENS)
        prop = OracleProposer(truth(side.fam, ps), wrong_at, side.vocab)
        eng = side.engine(k=K, proposer=prop)
        reqs = side.requests(ps, MAX_NEW)
        eng.generate(reqs)
        return {"tokens": tokens(reqs), "stats": eng.stats()}
    scenario.__name__ = f"edge_{wrong_at}"
    return scenario


@pytest.mark.parametrize("fam,wrong_at,expect", [
    ("dense", 0, "none"), ("dense", 1, "partial"), ("dense", None, "all"),
    ("int8", 1, "partial"), ("mla", 1, "partial")])
def test_acceptance_edges_like_jax(fam, wrong_at, expect):
    """Whatever the drafts, the tokens are those of the run without
    speculation and JAX's; the counters land where the script says and
    equal JAX's."""
    want, got = pair(fam, _edge(wrong_at))
    assert got["tokens"] == want["tokens"]
    assert got["tokens"] == _plain(truth(fam, prompts(0, LENS)))
    s = got["stats"]
    assert s["spec_proposed"] > 0
    if expect == "none":
        assert s["spec_accepted"] == 0
    elif expect == "partial":
        assert 0 < s["spec_accepted"] < s["spec_proposed"]
    else:
        assert s["spec_accepted"] == s["spec_proposed"]
        # multi-token commits: fewer decode row-steps than tokens
        assert s["sched_decode_rows"] < len(LENS) * MAX_NEW
    assert s["step_calls"] == s["sched_ticks"] == s["fused_steps"]
    assert_counters_equal(s, want["stats"])


# ---------------------------------------------------------------- rollback
def rollback(side):
    """Always-wrong drafts on a pool of ``max_pages + 3`` pages: every
    tick allocates draft pages and rewinds them."""
    ps = prompts(0, LENS)
    prop = OracleProposer(truth(side.fam, ps), 0, side.vocab)
    eng = side.engine(k=K, proposer=prop, pages=MAX_LEN // PAGE_TOKENS + 3)
    reqs = side.requests(ps, MAX_NEW)
    eng.generate(reqs)
    kv = eng.tiered
    return {"tokens": tokens(reqs), "stats": eng.stats(),
            "users": dict(kv.page_users),
            "free_idle": len(kv.free_pages) + kv._idle_index_pages(),
            "pool_pages": kv.pool_pages, "group": kv._group_bytes}


@pytest.mark.parametrize("fam", FAMS)
def test_rollback_keeps_the_pool_invariant_like_jax(fam):
    want, got = pair(fam, rollback)
    assert got["tokens"] == want["tokens"]
    assert got["tokens"] == _plain(truth(fam, prompts(0, LENS)))
    assert not got["users"] and got["free_idle"] == got["pool_pages"]
    s = got["stats"]
    assert s["spec_proposed"] > 0 and s["spec_accepted"] == 0
    assert s["pool_d2h_bytes"] == s["pool_page_spills"] * got["group"]
    assert s["pool_h2d_bytes"] == (
        (s["pool_faults"] + s["prefetch_hits"]) * got["group"]
        + s["restore_in_bytes"])
    assert_counters_equal(s, want["stats"])


# ------------------------------------------------------------- composition
def preemption(side):
    """Drafts on a pool of ``max_pages + 1`` pages with 5-token chunks:
    rows preempt and restore mid-speculation. Records every counter after
    every tick."""
    ps = prompts(0, PRESSURE_LENS)
    prop = OracleProposer(truth(side.fam, ps), 1, side.vocab)
    eng = side.engine(k=K, proposer=prop, pages=MAX_LEN // PAGE_TOKENS + 1,
                      chunk=5)
    reqs = side.requests(ps, MAX_NEW)
    sched = (JaxScheduler if side.pkg == "jax" else Scheduler)(eng, reqs)
    ticks = [eng.stats()]
    while sched.tick():
        ticks.append(eng.stats())
    eng.sched_stats = sched.stats.as_dict()
    return {"tokens": tokens(reqs), "ticks": ticks, "stats": eng.stats()}


@pytest.mark.parametrize("fam", FAMS)
def test_speculation_across_preemption_like_jax(fam):
    """Speculating rows preempt and restore; after every tick the counters
    equal JAX's, ``spec_proposed``/``spec_accepted`` never run backwards
    or cross, and the tokens are those of the run without speculation."""
    want, got = pair(fam, preemption)
    assert got["tokens"] == want["tokens"]
    assert got["tokens"] == _plain(truth(fam, prompts(0, PRESSURE_LENS)))
    s = got["stats"]
    assert s["preempts"] >= 1 and s["restores"] >= 1
    assert s["spec_accepted"] > 0
    assert len(got["ticks"]) == len(want["ticks"])
    prev = got["ticks"][0]
    for cur, ref in zip(got["ticks"], want["ticks"]):
        assert prev["spec_proposed"] <= cur["spec_proposed"]
        assert prev["spec_accepted"] <= cur["spec_accepted"]
        assert cur["spec_accepted"] <= cur["spec_proposed"]
        assert_counters_equal(
            cur, ref, [k for k in COUNTERS if not k.startswith("sched_")])
        prev = cur
    assert_counters_equal(s, want["stats"])


def _splice_prompts():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 512, 9, dtype=np.int32)
    return [base.copy(), base.copy(),
            np.concatenate([base[:6], rng.integers(0, 512, 2,
                                                   dtype=np.int32)])]


def splice(side):
    """Duplicate prompts adopt shared pages, then speculate."""
    ps = _splice_prompts()
    prop = OracleProposer(truth(side.fam, ps, prefix_tokens=4096), 1,
                          side.vocab)
    eng = side.engine(k=K, proposer=prop, prefix_tokens=4096,
                      max_batch_seqs=2)
    reqs = side.requests(ps, MAX_NEW)
    eng.generate(reqs)
    return {"tokens": tokens(reqs), "stats": eng.stats()}


@pytest.mark.parametrize("fam", FAMS)
def test_speculation_after_prefix_splice_like_jax(fam):
    want, got = pair(fam, splice)
    assert got["tokens"] == want["tokens"]
    assert got["tokens"] == _plain(truth(fam, _splice_prompts(), 4096))
    s = got["stats"]
    assert s["sched_spliced"] >= 1 and s["prefix_hits"] >= 1
    assert 0 < s["spec_accepted"] < s["spec_proposed"]
    assert_counters_equal(s, want["stats"])


# ----------------------------------------------------------- launch economy
@pytest.mark.parametrize("fam", FAMS)
def test_fused_tick_with_drafts_is_one_launch(fam, monkeypatch):
    """Every tick calls the family's ragged attention entry once a layer,
    drafts included, and decode rows with ``1 + k`` slots run at Qmax
    ``bucket(1 + k) = 8``."""
    entry = {"dense": "paged_attention_ragged",
             "int8": "paged_attention_ragged_q8",
             "mla": "mla_paged_attention_ragged"}[fam]
    qmax = []
    real = getattr(attention, entry)
    ps = prompts(0, LENS)
    want = truth(fam, ps)         # before the patch: a cold cache generates

    def counted(q, *a, **kw):
        qmax.append(q.shape[1])
        return real(q, *a, **kw)
    monkeypatch.setattr(attention, entry, counted)
    side = Side("torch", fam)
    eng = side.engine(k=K, proposer=OracleProposer(want, None))
    reqs = side.requests(ps, MAX_NEW)
    eng.generate(reqs)
    s = eng.stats()
    layers = models(fam)[2].cfg.num_layers
    assert s["step_calls"] == s["sched_ticks"] == s["fused_steps"]
    assert len(qmax) == layers * s["sched_ticks"]
    assert qmax.count(8) >= layers and s["spec_accepted"] > 0
    assert tokens(reqs) == _plain(truth(fam, ps))
