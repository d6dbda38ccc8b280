"""The port's prefix cache against the JAX package's.

* the port's ``TokenRadixTree`` gives the JAX trie's match, find, refcount
  and evictable answers over the same seeded sequence of operations;
* copy-on-write of a shared pool page copies EVERY paged plane of the
  family (dense k/v, int8 codes with their scale planes, MLA's ``c`` and
  ``kr``) exactly as the JAX engine does, and leaves the original alone;
* the scenarios of ``tests/test_prefix_cache.py`` (cached re-admission,
  shared-prefix tails, concurrent duplicates that copy-on-write their
  boundary page, sharing under a pool tight enough to preempt, churn) run
  on the ``paged`` engine for the dense, int8 and MLA families: the tokens
  and every prefix, COW, spill and per-plane byte counter equal the JAX
  engine's on the same schedule, with ``mirror_d2h_bytes == 0``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import SimClock as JaxSimClock
from repro.core import create_kv_engine as jax_create_kv_engine
from repro.core.engines import EngineSpec as JaxEngineSpec
from repro.core.kvcache import KVSpec as JaxKVSpec
from repro.core.radix import TokenRadixTree as JaxTokenRadixTree
from repro.serving import Scheduler as JaxScheduler
from repro_torch.core import SimClock
from repro_torch.core.engines import EngineSpec, create_kv_engine
from repro_torch.core.kvcache import KVSpec
from repro_torch.core.radix import TokenRadixTree
from repro_torch.serving import Scheduler

from torch_serving_pairs import (COUNTERS, FAMILIES, MAX_LEN, PAGE_TOKENS,
                                 Side, assert_counters_equal, models, pair,
                                 prompts, tokens)
from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)

FAMS = list(FAMILIES)
MAX_NEW = 6
PROMPT_LEN = 10          # % PAGE_TOKENS = 2: the last chunk is mid-page


# ------------------------------------------------------------------- trie
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_trie_matches_jax(seed):
    """Random inserts, matches, finds, refcounts and removals over a
    three-letter alphabet (so prefixes collide): every answer of the port's
    trie equals the JAX trie's, and both reject a refcount underflow."""
    rng = np.random.default_rng(seed)
    trees = (JaxTokenRadixTree(), TokenRadixTree())
    nodes = ([], [])          # the same node, by insertion order, per tree

    def key():
        return tuple(int(t) for t in rng.integers(0, 3, rng.integers(1, 7)))

    for step in range(300):
        op = rng.integers(0, 6)
        k = key()
        if op == 0:
            for t, ns in zip(trees, nodes):
                ns.append(t.insert(k, (step, k)))
        elif op == 1:
            got = [[n.value for n in t.match(k)] for t in trees]
            assert got[0] == got[1]
        elif op == 2:
            got = [t.find(k) for t in trees]
            assert (got[0] is None) == (got[1] is None)
            assert [t.lookup(k) for t in trees][0] == trees[1].lookup(k)
        elif nodes[0]:
            i = int(rng.integers(0, len(nodes[0])))
            pick = [ns[i] for ns in nodes]
            if op == 3:
                for t, n in zip(trees, pick):
                    t.acquire(n)
            elif op == 4:
                outs = []
                for t, n in zip(trees, pick):
                    try:
                        t.release(n)
                        outs.append("ok")
                    except RuntimeError:
                        outs.append("underflow")
                assert outs[0] == outs[1]
            else:
                ev = [t.evictable(n) for t, n in zip(trees, pick)]
                assert ev[0] == ev[1]
                if ev[0]:
                    for t, n in zip(trees, pick):
                        t.remove(n)
        assert len(trees[0]) == len(trees[1])
    assert sorted(trees[0].items()) == sorted(trees[1].items())


# ---------------------------------------------------------- copy-on-write
@pytest.mark.parametrize("fam", FAMS)
def test_cow_copies_every_plane_like_jax(fam):
    """Sequence 1 adopts sequence 0's two pages (6 tokens: the second page
    half full); its next write lands in that shared page, so
    ``prepare_step`` copies it. Every plane of the copy equals the original
    (int8 scales and MLA's ``kr`` included), the original is untouched, and
    tables, counters and the clock equal the JAX engine's."""
    jmodel, _, tmodel = models(fam)
    desc = tmodel.cache_descriptor(PAGE_TOKENS)
    jdesc = jmodel.cache_descriptor(PAGE_TOKENS)
    rng = np.random.default_rng(5)
    planes = {}
    for p in desc.paged_planes:       # values exact in the plane's dtype
        shape = (desc.num_layers, 6, PAGE_TOKENS) + p.shape
        planes[p.name] = (rng.integers(-127, 128, shape).astype(np.int8)
                          if p.dtype == "int8" else
                          torch.from_numpy(rng.standard_normal(shape)).to(
                              p.torch_dtype).float().numpy())
    geom = dict(num_layers=desc.num_layers, kv_heads=1, head_dim=1,
                page_tokens=PAGE_TOKENS)
    jkv = jax_create_kv_engine(JaxEngineSpec(engine="paged"),
                               JaxKVSpec(**geom, desc=jdesc), JaxSimClock())
    jkv.init_pool(pages=6)
    tkv = create_kv_engine(EngineSpec(engine="paged"),
                           KVSpec(**geom, desc=desc), SimClock())
    tkv.init_pool(pages=6, device="cpu")
    names = [p.name for p in desc.paged_planes]
    for kv, conv in ((jkv, lambda a, t: jnp.asarray(a, t.dtype)),
                     (tkv, lambda a, t: torch.from_numpy(a).to(t.dtype))):
        kv.alloc_prefill(0, 6)
        kv.commit_prefill_planes(
            tuple(conv(planes[n], v) for n, v in zip(names, kv.pool_views())),
            0, 6)
        kv.adopt_pages(1, kv.block_table[0], 6)
        kv.prepare_step([1], [1], 4)
        kv.commit_step_planes(kv.pool_views(), [1], [1])
    assert tkv.block_table == jkv.block_table
    src, dst = tkv.block_table[0][1], tkv.block_table[1][1]
    assert src != dst and tkv.stats["cow_copies"] == 1
    for n, t, j in zip(names, tkv.pool_views(), jkv.pool_views()):
        t = t.float().numpy()
        np.testing.assert_array_equal(t, np.asarray(j, np.float32), n)
        np.testing.assert_array_equal(t[:, dst], t[:, src], n)
        np.testing.assert_array_equal(t[:, src],
                                      planes[n][:, src].astype(np.float32), n)
    for k in ("cow_copies", "shared_pages", "prefix_hits",
              "prefix_tokens_reused", "pool_appends"):
        assert tkv.stats[k] == jkv.stats[k], k
    assert tkv.clock.now == pytest.approx(jkv.clock.now, rel=1e-12)


# ----------------------------------------------------------- the scenarios
def readmission(side):
    """The same prompt admitted twice in a row: the second splices."""
    prompt = prompts(0, [PROMPT_LEN])[0]
    eng = side.engine(prefix_tokens=4096)
    r0, r1 = side.requests([prompt, prompt], MAX_NEW)
    eng.generate([r0])
    s1 = eng.stats()
    eng.generate([r1])
    return {"tokens": tokens([r0, r1]), "s1": s1, "stats": eng.stats()}


def tails(side):
    """Distinct tails behind one 8-token (two-page) prefix, one request at
    a time, then the three again (fresh ids) over the warm index."""
    rng = np.random.default_rng(1)
    head = rng.integers(0, 512, 8, dtype=np.int32)
    ps = [np.concatenate([head, rng.integers(0, 512, n, dtype=np.int32)])
          for n in (3, 5, 2)]
    eng = side.engine(prefix_tokens=4096, max_batch_seqs=1)
    one = side.requests(ps, MAX_NEW)
    for r in one:
        eng.generate([r])
    s1 = eng.stats()
    again = side.requests(ps, MAX_NEW, first_rid=10)
    eng.generate(again)
    return {"tokens": tokens(one) + tokens(again), "s1": s1,
            "stats": eng.stats()}


def duplicates(side):
    """Three copies of one prompt and another prompt in ONE batch: the
    copies alias the mid-page boundary page, and the first decode write
    while others still trust it must copy it."""
    p, q = prompts(2, [PROMPT_LEN, PROMPT_LEN])
    eng = side.engine(prefix_tokens=4096)
    reqs = side.requests([p, p, p, q], MAX_NEW)
    eng.generate(reqs)
    return {"tokens": tokens(reqs), "stats": eng.stats()}


def pressure(side):
    """A pool of ``max_pages + 1`` pages and 5-token chunks: a warm-up
    request publishes its prompt, then duplicates and another prompt
    preempt each other. Records every counter after every tick."""
    p, q = prompts(4, [PROMPT_LEN, 12])
    eng = side.engine(prefix_tokens=4096, pages=MAX_LEN // PAGE_TOKENS + 1,
                      chunk=5)
    warm = side.request(99, p, MAX_NEW)
    eng.generate([warm])
    reqs = side.requests([p, p, q, p], MAX_NEW)
    sched = (JaxScheduler if side.pkg == "jax" else Scheduler)(eng, reqs)
    ticks = [eng.stats()]
    while sched.tick():
        ticks.append(eng.stats())
    eng.sched_stats = sched.stats.as_dict()
    return {"tokens": tokens([warm] + reqs), "ticks": ticks,
            "stats": eng.stats(), "preempts": eng.tiered.stats["preempts"]}


def churn(side):
    """Three rounds of three copies of one prompt through one engine."""
    p, = prompts(7, [PROMPT_LEN])
    eng = side.engine(prefix_tokens=4096)
    out = []
    for round_ in range(3):
        reqs = side.requests([p] * 3, MAX_NEW, first_rid=10 * round_)
        eng.generate(reqs)
        out += tokens(reqs)
    kv = eng.tiered
    return {"tokens": out, "stats": eng.stats(),
            "users": dict(kv.page_users),
            "free_idle": len(kv.free_pages) + kv._idle_index_pages(),
            "pool_pages": kv.pool_pages, "pressure": kv.pressure()}


@pytest.mark.parametrize("fam", FAMS)
def test_cached_readmission_splices_like_jax(fam):
    """The second admission of the same prompt splices: ``prefill_calls``
    does not move, the prompt is covered up to ``len - 1`` tokens, and the
    tokens and counters equal JAX's."""
    want, got = pair(fam, readmission)
    assert got["tokens"] == want["tokens"]
    assert got["tokens"][0] == got["tokens"][1]
    s1, s2 = got["s1"], got["stats"]
    assert s1["prefix_hits"] == 0 and s2["prefix_hits"] == 1
    assert s2["prefix_tokens_reused"] == PROMPT_LEN - 1
    assert s2["prefill_calls"] == s1["prefill_calls"]
    assert_counters_equal(s1, want["s1"])
    assert_counters_equal(s2, want["stats"])


@pytest.mark.parametrize("fam", FAMS)
def test_shared_prefix_tails_splice_like_jax(fam):
    """Later prompts behind a cached two-page prefix cover those pages and
    prefill only their own tail; batched over a warm index too."""
    want, got = pair(fam, tails)
    assert got["tokens"] == want["tokens"]
    assert got["tokens"][:3] == got["tokens"][3:]
    assert got["s1"]["prefix_hits"] == 2
    assert got["s1"]["prefix_tokens_reused"] == 16
    assert got["stats"]["prefix_hits"] == 5
    assert_counters_equal(got["s1"], want["s1"])
    assert_counters_equal(got["stats"], want["stats"])


@pytest.mark.parametrize("fam", FAMS)
def test_concurrent_duplicates_cow_boundary_page_like_jax(fam):
    """Spliced duplicates write into the shared boundary page, which must
    be copied across every plane first: tokens equal JAX's (and, where the
    cache is not quantized, the port's sequential reference), the copies
    produce identical streams, and the counters equal JAX's."""
    want, got = pair(fam, duplicates)
    s = got["stats"]
    assert s["prefix_hits"] >= 2 and s["cow_copies"] >= 1
    assert s["shared_pages"] >= 1
    assert got["tokens"] == want["tokens"]
    assert got["tokens"][0] == got["tokens"][1] == got["tokens"][2]
    assert_counters_equal(s, want["stats"])
    if fam != "int8":         # int8: a spliced tail attends quantized K/V
        side = Side("torch", fam)
        p, q = prompts(2, [PROMPT_LEN, PROMPT_LEN])
        ref = side.requests([p, p, p, q], MAX_NEW)
        side.engine().generate_sequential(ref)
        assert tokens(ref) == got["tokens"]


@pytest.mark.parametrize("fam", FAMS)
def test_sharing_under_pressure_like_jax(fam):
    """Tight pool + chunked prefill + duplicates: preemption fires, the
    prefix cache still hits, every counter is monotone tick by tick and
    equals JAX's after every tick, and no token moves."""
    want, got = pair(fam, pressure)
    assert got["tokens"] == want["tokens"]
    assert got["preempts"] >= 1 and got["stats"]["prefix_hits"] >= 1
    assert len(got["ticks"]) == len(want["ticks"])
    prev = got["ticks"][0]
    for cur, ref in zip(got["ticks"], want["ticks"]):
        assert set(cur) == set(prev)
        assert all(v >= prev[k] for k, v in cur.items()), cur
        assert_counters_equal(
            cur, ref, [k for k in COUNTERS if not k.startswith("sched_")])
        prev = cur
    assert_counters_equal(got["stats"], want["stats"])


@pytest.mark.parametrize("fam", FAMS)
def test_churn_releases_every_shared_page_like_jax(fam):
    """After three rounds of duplicates no page holds a live user: the pool
    is exactly free pages plus idle index pages and pressure is 0, as in
    the JAX engine."""
    want, got = pair(fam, churn)
    assert got["tokens"] == want["tokens"]
    assert not got["users"]
    assert got["free_idle"] == got["pool_pages"]
    assert got["pressure"] == 0.0
    assert got["stats"]["prefix_hits"] >= 1
    assert_counters_equal(got["stats"], want["stats"])
