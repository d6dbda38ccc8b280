"""The port's host-tier KV engines — ``log``, ``kvhybrid`` and ``paged`` in
host mode — against the JAX package's, on the same appends.

The scenarios of ``tests/test_kv_engines.py`` and ``tests/test_kvcache.py``
(3 layers, 2 KV heads, head_dim 8, 4-token pages, float16 tokens from a
seeded numpy generator) drive both packages' engines side by side: every
``read()`` is bitwise equal, and ``stats`` are equal key for key, floats
(``stall_time``) included, as are the simulated clocks. Preempt/restore
round-trips, drain shards 1 and 4, the slow-drainer force-drain, the
adaptive router's convergence and the kvhybrid victim hint are replayed
too.
"""
import numpy as np
import pytest
import torch

from repro.core import SimClock as JaxSimClock
from repro.core.engines import EngineSpec as JaxEngineSpec
from repro.core.engines import create_kv_engine as jax_create_kv_engine
from repro.core.kvcache import AdaptiveRouter as JaxAdaptiveRouter
from repro.core.kvcache import KVSpec as JaxKVSpec
from repro_torch.core import SimClock
from repro_torch.core.engines import (EngineSpec, create_kv_engine,
                                      get_kv_engine, list_kv_engines)
from repro_torch.core.kvcache import (AdaptiveRouter, HybridKVCache, KVSpec,
                                      LogKVCache, PagedKVCache)

GEOM = dict(num_layers=3, kv_heads=2, head_dim=8, page_tokens=4)
L, K, D, T = 3, 2, 8, 4
KV_ENGINES = ("paged", "log", "kvhybrid")


class Pair:
    """The same engine in both packages, fed the same operations."""

    def __init__(self, engine, **spec_kw):
        spec_kw.setdefault("kv_hbm_bytes", 1 << 13)
        spec_kw.setdefault("kv_hot_window", 6)
        self.jclock, self.tclock = JaxSimClock(), SimClock()
        self.j = jax_create_kv_engine(JaxEngineSpec(engine=engine, **spec_kw),
                                      JaxKVSpec(**GEOM), self.jclock)
        self.t = create_kv_engine(EngineSpec(engine=engine, **spec_kw),
                                  KVSpec(**GEOM), self.tclock)

    def append(self, seq, arr):
        self.j.append(seq, arr)
        self.t.append(seq, torch.from_numpy(arr.copy()))

    def append_many(self, items):
        self.j.append_many(items)
        self.t.append_many([(s, torch.from_numpy(a.copy()))
                            for s, a in items])

    def read(self, seq, layer):
        """Both reads; asserts them bitwise equal and returns the JAX one."""
        want = np.asarray(self.j.read(seq, layer))
        got = self.t.read(seq, layer)
        assert got.dtype == torch.float16
        np.testing.assert_array_equal(got.numpy(), want)
        return want

    def call(self, name, *args):
        a = getattr(self.j, name)(*args)
        b = getattr(self.t, name)(*args)
        assert a == b, (name, a, b)
        return a

    def check(self):
        """Stats key for key (floats too), clocks, lengths, pressure."""
        assert self.t.stats == self.j.stats
        assert self.tclock.now == self.jclock.now
        assert self.t.seq_len == self.j.seq_len
        for name in ("hbm_used_bytes", "hbm_limit_bytes", "pressure"):
            assert getattr(self.t, name)() == getattr(self.j, name)(), name


def _tok(rng):
    return rng.standard_normal((L, 2, K, D)).astype(np.float16)


def _burst(rng, n):
    return rng.standard_normal((L, 2, n, K, D)).astype(np.float16)


def test_registry_serves_the_three_engines():
    assert set(KV_ENGINES) <= set(list_kv_engines())
    for name, cls in (("paged", PagedKVCache), ("log", LogKVCache),
                      ("kvhybrid", HybridKVCache)):
        kv = Pair(name).t
        assert isinstance(kv, cls) and kv.engine_name == name
        assert get_kv_engine(name) is cls
    assert not Pair("paged").t.pooled       # host mode unless init_pool()


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("engine", KV_ENGINES)
def test_interleaved_appends_read_like_jax(engine, shards):
    """``test_append_read_round_trip``'s schedule (singles and 5-token
    bursts over three sequences), reads between appends as well."""
    p = Pair(engine, drain_shards=shards)
    rng = np.random.default_rng(0)
    oracle = {s: [] for s in range(3)}
    for step in range(30):
        s = step % 3
        if step % 7 == 3:
            burst = _burst(rng, 5)
            p.append(s, burst)
            oracle[s].extend(burst[:, :, t] for t in range(5))
        else:
            tok = _tok(rng)
            p.append(s, tok)
            oracle[s].append(tok)
        if step % 4 == 1:
            p.read(s, step % L)
        p.check()
    for s in range(3):
        for layer in range(L):
            want = np.stack([o[layer] for o in oracle[s]], axis=1)
            np.testing.assert_array_equal(p.read(s, layer), want)
    p.check()


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("engine", KV_ENGINES)
def test_preempt_restore_round_trip_like_jax(engine, shards):
    p = Pair(engine, drain_shards=shards)
    rng = np.random.default_rng(2)
    for _ in range(13):
        p.append(0, _tok(rng))
        p.append(1, _tok(rng))
    before = [p.read(0, layer) for layer in range(L)]
    p.call("preempt", 0)
    p.check()
    assert p.tclock.bytes_moved("ssd", "write") > 0
    with pytest.raises(RuntimeError, match="preempted"):
        p.t.read(0, 0)
    with pytest.raises(RuntimeError, match="preempted"):
        p.t.append(0, torch.from_numpy(_tok(rng)))
    p.read(1, 0)
    p.call("restore", 0)
    p.check()
    for layer in range(L):
        np.testing.assert_array_equal(p.read(0, layer), before[layer])
    with pytest.raises(RuntimeError, match="not preempted"):
        p.t.restore(0)
    p.call("release", 0)
    p.call("release", 1)
    p.check()
    assert p.t.hbm_used_bytes() == p.j.hbm_used_bytes()


@pytest.mark.parametrize("engine", KV_ENGINES)
def test_batched_decode_appends_and_tight_budget_like_jax(engine):
    """``append_many`` decode steps over four sequences on a budget that
    binds (the hot-window total, or the paged HBM working set): eviction,
    DMA misses and patches follow the JAX engine's."""
    p = Pair(engine, kv_hbm_bytes=6 * T * L * 2 * K * D * 2, drain_shards=2,
             hybrid_threshold=1 << 10)
    rng = np.random.default_rng(21)
    for s in range(4):
        p.append(s, _burst(rng, 3 + 2 * s))
    for step in range(12):
        p.append_many([(s, _tok(rng)) for s in range(4)])
        if step % 3 == 2:
            for s in range(4):
                p.read(s, step % L)
            p.call("victim_hint", [0, 1, 2, 3])
            for s in range(4):
                p.call("resident_bytes", s)
        p.check()
    p.call("preempt", 2)
    p.append_many([(s, _tok(rng)) for s in (0, 1, 3)])
    p.call("restore", 2)
    for s in range(4):
        p.read(s, 1)
    p.check()


def test_slow_drainer_force_drain_like_jax():
    """``test_force_drain_before_page_ownership``: a backlogged shard
    force-drains before the page side takes a page — the stall time and
    the drain counters equal JAX's."""
    p = Pair("kvhybrid", drain_shards=2, hybrid_threshold=1 << 20)
    for kv in (p.j, p.t):
        kv._drain_service = lambda: 1.0
    rng = np.random.default_rng(5)
    for _ in range(3):
        p.append(0, _tok(rng))
    p.append(1, _tok(rng))
    p.read(0, 1)                          # patches from the pending log
    p.check()
    p.j.router.threshold = p.t.router.threshold = 1   # route to pages
    p.append(0, _burst(rng, 6))
    p.check()
    assert p.t.stats["force_drains"] == 1 and p.t.stats["stall_time"] > 0
    assert p.t.page_owned == p.j.page_owned
    for layer in range(L):
        p.read(0, layer)
    p.jclock.advance(3.0)
    p.tclock.advance(3.0)
    p.read(1, 0)
    p.check()


@pytest.mark.parametrize("engine", ["log", "kvhybrid"])
def test_shard_backlog_like_jax(engine):
    """``test_kv_shard_independence`` at 1 and 2 shards: the pending
    entries' finish times and the patches of a backlogged read."""
    for shards in (1, 2):
        p = Pair(engine, drain_shards=shards, hybrid_threshold=1 << 20)
        for kv in (p.j, p.t):
            kv._drain_service = lambda: 1.0
        rng = np.random.default_rng(4)
        for _ in range(8):
            p.append(0, _tok(rng))
        p.append(1, _tok(rng))
        p.call("pending_for", 1)
        shard = p.t.drainer.shard_of(1)
        assert [e[3] for e in p.t.shard_log[shard]] == \
            [e[3] for e in p.j.shard_log[shard]]
        p.read(0, 0)
        p.check()


@pytest.mark.parametrize("case", ["small", "large", "mixed"])
def test_adaptive_router_converges_like_jax(case):
    """The three convergence workloads of ``tests/test_kv_engines.py``:
    same learned threshold, same routing counts."""
    if case == "small":
        p = Pair("kvhybrid", hybrid_threshold=1)
        rng = np.random.default_rng(7)
        for t in range(400):
            p.append(t % 4, _tok(rng))
        assert p.t.stats["routed_log"] >= 360
    elif case == "large":
        p = Pair("kvhybrid", hybrid_threshold=1 << 20)
        rng = np.random.default_rng(8)
        for t in range(200):
            p.append(t % 4, _burst(rng, 8 * T))
        assert p.t.threshold <= p.t.spec.page_bytes
    else:
        p = Pair("kvhybrid", kv_hot_window=64)
        rng = np.random.default_rng(9)
        for s in range(4):
            p.append(s, _burst(rng, 8 * T))
        for t in range(200):
            p.append(t % 4, _tok(rng))
            if t % 50 == 25:
                p.read(t % 4, 0)
        small = p.t.spec.token_bytes * L
        assert small < p.t.threshold <= 8 * p.t.spec.page_bytes
    assert p.t.threshold == p.j.threshold
    assert p.t.router.hist == p.j.router.hist
    assert p.t.router.gather_lat_s == p.j.router.gather_lat_s
    p.check()


def test_router_latency_feedback_like_jax():
    """``test_gather_latency_feedback_converges_from_wrong_prior`` on both
    packages' routers: the same EMA and thresholds at every step."""
    page_cost = 1e-6
    for lat in (10 * page_cost, page_cost):
        j = JaxAdaptiveRouter(1 << 20, 64, page_per_token_s=page_cost)
        t = AdaptiveRouter(1 << 20, 64, page_per_token_s=page_cost)
        for i in range(64):
            size = 128 if i % 2 else 8192
            assert t.route(size) == j.route(size)
            for r in (j, t):
                r.observe_read(seq=i % 3, hot_tokens=5, cold_tokens=5,
                               latency_s=lat * 10)
            assert (t.threshold, t.gather_lat_s) == \
                (j.threshold, j.gather_lat_s)


def test_hybrid_victim_hint_like_jax():
    p = Pair("kvhybrid")
    rng = np.random.default_rng(13)
    for _ in range(24):
        p.append(0, _tok(rng))
    for _ in range(5):
        p.append(1, _tok(rng))
    assert p.call("victim_hint", [0, 1]) is None
    p.read(0, 0)
    p.read(1, 0)
    assert p.t.router.reuse_score(0) == p.j.router.reuse_score(0)
    assert p.call("victim_hint", [0, 1]) == 0
    p.call("release", 0)
    assert p.t.router.reuse_score(0) is None
    p.check()


@pytest.mark.parametrize("engine", ["paged", "log"])
def test_paged_miss_and_log_hot_window_like_jax(engine):
    """``tests/test_kvcache.py``: the paged HBM-miss DMA cost on a 2-page
    working set, and the log hot window serving the newest tokens."""
    if engine == "paged":
        p = Pair("paged", kv_hbm_bytes=2 * T * 2 * K * D * 2)
    else:
        p = Pair("log", kv_hot_window=8)
    rng = np.random.default_rng(0)
    for _ in range(32):
        p.append(0, _tok(rng))
    p.read(0, 0)
    p.check()
    key = "hbm_misses" if engine == "paged" else "hot_hits"
    assert p.t.stats[key] > 0


def test_host_mode_paged_refuses_pool_methods():
    """The pool-only surface of host mode raises; the pressure surface and
    preempt/restore work without a pool."""
    kv = Pair("paged").t
    kv.append(0, torch.zeros((L, 2, K, D), dtype=torch.float16))
    with pytest.raises(RuntimeError, match="init_pool"):
        kv.prepare_step([0], [1], 4)
    with pytest.raises(RuntimeError, match="before any append"):
        kv.init_pool(device="cpu")
    assert kv.victim_hint([0]) is None and kv.can_admit_tokens(10 ** 6)


@pytest.mark.parametrize("case", ["page_route_skips_force_drain",
                                  "write_amplification",
                                  "engines_read_alike"])
def test_reference_scenarios_like_jax(case):
    """The remaining scenarios of ``tests/test_kv_engines.py`` and
    ``tests/test_kvcache.py``: a page-routed burst with no pending log
    entry skips the force-drain; paging writes every token to the host
    twice, logging once; and the three designs read alike."""
    rng = np.random.default_rng(6)
    if case == "page_route_skips_force_drain":
        p = Pair("kvhybrid", hybrid_threshold=1)
        p.append(0, _burst(rng, 8))
        p.check()
        assert p.t.stats["routed_pages"] == 1
        assert p.t.stats["force_drains"] == 0
    elif case == "write_amplification":
        paged, log = Pair("paged"), Pair("log")
        for _ in range(32):
            tok = _tok(rng)
            paged.append(0, tok)
            log.append(0, tok)
        for p in (paged, log):
            p.check()
        assert paged.tclock.bytes_moved("host", "write") >= \
            1.95 * log.tclock.bytes_moved("host", "write")
    else:
        pairs = {e: Pair(e) for e in KV_ENGINES}
        for t in range(40):
            arr = _burst(rng, 6) if t % 11 == 5 else _tok(rng)
            for p in pairs.values():
                p.append(t % 3, arr)
        for seq in range(3):
            for layer in range(L):
                reads = [p.read(seq, layer) for p in pairs.values()]
                for r in reads[1:]:
                    np.testing.assert_array_equal(r, reads[0])
        for p in pairs.values():
            p.check()
