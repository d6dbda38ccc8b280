"""The port's pooled, fused serving path against the JAX package's.

Settings of ``tests/test_paged_decode.py`` (``internlm2-1.8b-smoke``,
``max_len`` 24, 4-token pages, prompts of 8/12/8 tokens, 6 new tokens),
with the JAX ``LM.init`` weights carried across: the port's ``generate()``
is token-identical to the JAX ``generate_sequential`` reference, moves
zero mirror bytes, and runs one step per scheduler tick; under chunked
prefill and a pool tight enough to preempt it stays token-identical to the
port's own sequential reference, with the same page-spill counters as the
JAX engine's run of the same schedule. With ``async_tiering`` on, the
port's transfer pipeline is held to the JAX one: the same reads, spill
decisions, prefetch/fault split and simulated clock on a spill-heavy
engine-level schedule, and the same tokens and counters when serving.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import SimClock as JaxSimClock
from repro.core import create_kv_engine as jax_create_kv_engine
from repro.core.engines import EngineSpec as JaxEngineSpec
from repro.core.kvcache import KVSpec as JaxKVSpec
from repro.models import build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.core import SimClock
from repro_torch.core.engines import EngineSpec, create_kv_engine
from repro_torch.core.kvcache import KVSpec
from repro_torch.models import LM, params_from_jax
from repro_torch.serving import Request, ServeConfig, ServingEngine

ARCH = "internlm2-1.8b-smoke"
MAX_LEN = 24
PAGE_TOKENS = 4
PROMPT_LENS = (8, 12, 8)
MAX_NEW = 6


@pytest.fixture(scope="module")
def models():
    jmodel = build_model(jax_get_config(ARCH), remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH)
    tmodel = LM(cfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, tmodel


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n, dtype=np.int32) for n in PROMPT_LENS]


def _group_bytes(cfg):
    """One fp32 pool page group (all layers)."""
    return cfg.num_layers * 2 * PAGE_TOKENS * cfg.num_kv_heads \
        * cfg.head_dim * 4


def _torch_engine(model, *, hbm_bytes=64 << 20, chunk=None, fuse=True,
                  async_tiering=False):
    return ServingEngine(model, ServeConfig(
        max_len=MAX_LEN, page_tokens=PAGE_TOKENS,
        engine_spec=EngineSpec(engine="paged", kv_hbm_bytes=hbm_bytes,
                               async_tiering=async_tiering),
        max_batch_seqs=4, prefill_chunk_tokens=chunk, fuse_ticks=fuse),
        device="cpu")


def _jax_engine(jmodel, jparams, engine, *, hbm_bytes=64 << 20, chunk=None,
                paged_decode=None, async_tiering=False):
    return JaxServingEngine(jmodel, jparams, JaxServeConfig(
        max_len=MAX_LEN, page_tokens=PAGE_TOKENS,
        engine_spec=JaxEngineSpec(engine=engine, kv_hbm_bytes=hbm_bytes,
                                  kv_hot_window=8, drain_shards=2,
                                  async_tiering=async_tiering),
        max_batch_seqs=4, paged_decode=paged_decode,
        prefill_chunk_tokens=chunk))


def _torch_requests():
    return [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts())]


@pytest.fixture(scope="module")
def jax_reference(models):
    jmodel, jparams, _ = models
    reqs = [JaxRequest(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts())]
    _jax_engine(jmodel, jparams, "log",
                paged_decode=False).generate_sequential(reqs)
    return [r.generated for r in reqs]


def test_pooled_fused_generate_matches_jax_sequential(models, jax_reference):
    _, _, tmodel = models
    reqs = _torch_requests()
    eng = _torch_engine(tmodel)
    assert eng.pooled and eng.fused
    eng.generate(reqs)
    assert [r.generated for r in reqs] == jax_reference
    s = eng.stats()
    assert s["mirror_d2h_bytes"] == 0
    assert s["step_calls"] == s["sched_ticks"] == s["fused_steps"]


def test_chunked_tight_pool_matches_sequential_and_jax_counters(
        models, jax_reference):
    """Chunked prefill (5-token chunks) on an 8-page pool: rows preempt and
    pages spill, tokens do not move, and the spill counters equal the JAX
    engine's for the same schedule."""
    jmodel, jparams, tmodel = models
    budget = 8 * _group_bytes(tmodel.cfg)
    seq = _torch_requests()
    _torch_engine(tmodel).generate_sequential(seq)
    assert [r.generated for r in seq] == jax_reference
    reqs = _torch_requests()
    eng = _torch_engine(tmodel, hbm_bytes=budget, chunk=5)
    eng.generate(reqs)
    assert [r.generated for r in reqs] == [r.generated for r in seq]
    s = eng.stats()
    assert s["preempts"] >= 1 and s["pool_page_spills"] >= 1, s
    assert s["sched_prefill_chunks"] >= 2 and s["mirror_d2h_bytes"] == 0
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=MAX_NEW)
             for i, p in enumerate(_prompts())]
    jeng = _jax_engine(jmodel, jparams, "paged", hbm_bytes=budget, chunk=5)
    jeng.generate(jreqs)
    js = jeng.stats()
    for key in ("pool_page_spills", "pool_d2h_bytes", "pool_faults",
                "preempts", "restores", "sched_ticks"):
        assert s[key] == js[key], (key, s[key], js[key])


# The engine-level schedule of tests/test_tiering.py (spills, faults,
# prefetch, preempt/restore on a 5-page pool), fed to both packages.
KV_GEOM = dict(num_layers=2, kv_heads=2, head_dim=8, page_tokens=4)
ASYNC_KEYS = ("pool_page_spills", "pool_faults", "prefetch_hits",
              "async_spills", "stall_ticks_saved", "pool_d2h_bytes",
              "pool_h2d_bytes", "preempt_out_bytes", "restore_in_bytes")


def _pooled_kv_pair(async_tiering):
    jclock, tclock = JaxSimClock(), SimClock()
    jkv = jax_create_kv_engine(
        JaxEngineSpec(engine="paged", kv_hbm_bytes=1 << 30,
                      async_tiering=async_tiering),
        JaxKVSpec(**KV_GEOM, dtype=np.dtype(np.float32)), jclock)
    jkv.init_pool(dtype=np.float32, pages=5)
    tkv = create_kv_engine(
        EngineSpec(engine="paged", kv_hbm_bytes=1 << 30,
                   async_tiering=async_tiering),
        KVSpec(**KV_GEOM, dtype=torch.float32), tclock)
    tkv.init_pool(pages=5, device="cpu")
    return (jkv, jclock), (tkv, tclock)


def _drive_kv_schedule(kvs):
    """Run one spill/fault-heavy schedule on every engine in ``kvs``;
    returns each engine's reads as numpy arrays."""
    rng = np.random.default_rng(7)
    reads = [[] for _ in kvs]
    L, K, D = KV_GEOM["num_layers"], KV_GEOM["kv_heads"], KV_GEOM["head_dim"]
    for step in range(8):
        for seq in (0, 1, 2):
            toks = rng.standard_normal(
                (L, 2, 3 if step == 0 else 1, K, D)).astype(np.float32)
            for kv in kvs:
                kv.append(seq, toks)
        for kv in kvs:
            kv.prefetch([0, 1, 2])
        if step % 2:
            for kv, out in zip(kvs, reads):
                out += [np.asarray(kv.read(seq, layer=step % 2))
                        for seq in (0, 1, 2)]
    for kv, out in zip(kvs, reads):
        kv.preempt(0)
        kv.restore(0)
        out.append(np.asarray(kv.read(0, layer=1)))
        kv.flush_transfers()
    return reads


def test_async_tiering_engine_matches_jax():
    """Sync and async pooled engines, port against JAX on the same
    schedule: bit-identical reads, the same spill decisions and counters,
    the same simulated clock; async conserves faults exactly
    (``prefetch_hits + pool_faults == sync pool_faults``) and is faster."""
    runs = {}
    for async_tiering in (False, True):
        (jkv, jclock), (tkv, tclock) = _pooled_kv_pair(async_tiering)
        jreads, treads = _drive_kv_schedule([jkv, tkv])
        for got, want in zip(treads, jreads):
            np.testing.assert_array_equal(got, want)
        assert tkv.block_table == jkv.block_table
        for key in ASYNC_KEYS:
            assert tkv.stats[key] == jkv.stats[key], (key, async_tiering)
        assert tclock.now == pytest.approx(jclock.now, rel=1e-12)
        runs[async_tiering] = (tkv.stats, tclock.now, treads)
    (s, sync_now, sync_reads), (a, async_now, async_reads) = \
        runs[False], runs[True]
    for got, want in zip(async_reads, sync_reads):
        np.testing.assert_array_equal(got, want)
    assert s["pool_faults"] > 0 and a["prefetch_hits"] > 0
    assert a["async_spills"] > 0 and a["stall_ticks_saved"] > 0
    assert a["prefetch_hits"] + a["pool_faults"] == s["pool_faults"]
    assert a["pool_page_spills"] == s["pool_page_spills"]
    assert async_now < sync_now


def test_async_tiering_serving_matches_jax(models, jax_reference):
    """The chunked tight-pool run with ``async_tiering`` on: tokens equal
    the reference, and the tiering counters and simulated time equal the
    JAX engine's async run of the same schedule."""
    jmodel, jparams, tmodel = models
    budget = 8 * _group_bytes(tmodel.cfg)
    reqs = _torch_requests()
    eng = _torch_engine(tmodel, hbm_bytes=budget, chunk=5,
                        async_tiering=True)
    eng.generate(reqs)
    assert [r.generated for r in reqs] == jax_reference
    s = eng.stats()
    assert s["preempts"] >= 1 and s["mirror_d2h_bytes"] == 0
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=MAX_NEW)
             for i, p in enumerate(_prompts())]
    jeng = _jax_engine(jmodel, jparams, "paged", hbm_bytes=budget, chunk=5,
                       async_tiering=True)
    jeng.generate(jreqs)
    js = jeng.stats()
    for key in ASYNC_KEYS + ("preempts", "restores", "sched_ticks"):
        assert s[key] == js[key], (key, s[key], js[key])
    assert s["sim_time_s"] == pytest.approx(js["sim_time_s"], rel=1e-12)


def test_unfused_pooled_path_matches_reference(models, jax_reference):
    """``fuse_ticks=False``: chunks run token by token through the decode
    kernel entry (``extend_one``) — same tokens, still mirror-free."""
    _, _, tmodel = models
    reqs = _torch_requests()
    eng = _torch_engine(tmodel, chunk=5, fuse=False)
    eng.generate(reqs)
    assert [r.generated for r in reqs] == jax_reference
    assert eng.stats()["mirror_d2h_bytes"] == 0


def test_unported_features_refuse_at_construction(models, jax_reference):
    """The two configurations this test once saw refused —
    ``paged_decode=False`` and ``engine="log"`` — construct and serve
    through the dense mirror, token-identical to the JAX reference and
    with mirror bytes moved; what stays refused is ``paged_decode=True``
    on an engine with no pool (``ValueError``, as in JAX) and a silent
    CPU fallback."""
    _, _, tmodel = models
    for spec, paged_decode in ((EngineSpec(), False),
                               (EngineSpec(engine="log"), None)):
        eng = ServingEngine(tmodel, ServeConfig(
            max_len=MAX_LEN, page_tokens=PAGE_TOKENS, engine_spec=spec,
            paged_decode=paged_decode), device="cpu")
        assert not eng.pooled
        reqs = _torch_requests()
        eng.generate(reqs)
        assert [r.generated for r in reqs] == jax_reference
        assert eng.stats()["mirror_d2h_bytes"] > 0
    with pytest.raises(ValueError, match="paged_decode=True"):
        ServingEngine(tmodel, ServeConfig(
            max_len=MAX_LEN, page_tokens=PAGE_TOKENS, paged_decode=True,
            engine_spec=EngineSpec(engine="log")), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):     # no silent CPU fallback
            LM(tmodel.cfg)
