"""The port's dense-mirror serving path against the JAX package's.

Each (KV engine, fused/unfused, cache family) serves the same seeded
requests on both packages at smoke width (``tests/torch_serving_pairs.py``:
the JAX ``LM.init`` weights carried across, fp32, ``max_len`` 48, 4-token
pages, 5-token prefill chunks): ``log``, ``kvhybrid``, and ``paged`` with
``paged_decode=False`` (its host mode). ``generate()`` gives JAX's tokens,
and ``stats()`` equals JAX's key for key — ``mirror_d2h_bytes``, every tier
counter and the simulated clock included. Hot-window and HBM budgets tight
enough to preempt, speculative decode and a crash recovered from the
journal are replayed the same way on ``log``; ``paged_decode=True`` on
``log`` raises as in JAX, and an auto ``paged`` engine whose budget cannot
hold a max-length sequence falls back to the mirror as in JAX.

``LM.step_ragged`` (the mirror's fused step) is held to the JAX step
within the tolerance ``tests/test_kernels.py`` holds the ragged entries to
their oracle (atol 1e-4, rtol 4e-5), and at ``q_len == 1`` everywhere it
equals the port's own ``decode_step`` bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engines import EngineSpec as JaxEngineSpec
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.core.engines import EngineSpec
from repro_torch.serving import ServeConfig, ServingEngine

from torch_serving_pairs import (FAMILIES, MAX_LEN, PAGE_TOKENS, Side,
                                 models, prompts, stats_mismatch, tokens)
from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)

FAMS = list(FAMILIES)
ENGINES = ("log", "kvhybrid", "paged")
PROMPTS = (8, 12, 8, 5)
MAX_NEW = 6
CHUNK = 5


def token_bytes(fam) -> int:
    """One fp16 mirror token over every layer (the hot-window unit)."""
    cfg = models(fam)[2].cfg
    return cfg.num_layers * 2 * max(cfg.num_kv_heads, 1) \
        * max(cfg.head_dim, 1) * 2


def engine(pkg, fam, name, *, hbm=64 << 20, fuse=True, k=0, journal=None,
           plan=None, paged_decode=False):
    spec_kw = dict(engine=name, kv_hbm_bytes=hbm, kv_hot_window=8,
                   drain_shards=2)
    kw = dict(max_len=MAX_LEN, page_tokens=PAGE_TOKENS, max_batch_seqs=4,
              prefill_chunk_tokens=CHUNK, fuse_ticks=fuse, speculate_k=k,
              paged_decode=paged_decode, journal=journal, fault_plan=plan)
    jmodel, jparams, tmodel = models(fam)
    if pkg == "jax":
        return JaxServingEngine(jmodel, jparams, JaxServeConfig(
            engine_spec=JaxEngineSpec(**spec_kw), **kw))
    return ServingEngine(tmodel, ServeConfig(
        engine_spec=EngineSpec(**spec_kw), **kw), device="cpu")


def serve_both(fam, name, **kw):
    """``generate()`` on both packages; asserts the port serves through the
    mirror, with JAX's tokens and stats. Returns the port's stats."""
    out = {}
    for pkg in ("jax", "torch"):
        eng = engine(pkg, fam, name, **kw)
        reqs = Side(pkg, fam).requests(prompts(0, PROMPTS), MAX_NEW)
        eng.generate(reqs)
        assert not eng.pooled
        out[pkg] = (tokens(reqs), eng.stats())
    (jt, js), (tt, ts) = out["jax"], out["torch"]
    assert tt == jt
    assert all(len(t) == MAX_NEW for t in tt)
    bad = stats_mismatch(ts, js)
    assert not bad, f"port != JAX (port, jax): {bad}"
    return ts


@pytest.mark.parametrize("fam", FAMS)
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", ENGINES)
def test_mirror_serving_matches_jax(name, fuse, fam):
    s = serve_both(fam, name, fuse=fuse)
    if fam == "mla":
        # an MLA row has no k/v: nothing crosses the link, nothing appends
        assert s["mirror_d2h_bytes"] == 0 and s["releases"] == 0
    else:
        assert s["mirror_d2h_bytes"] > 0
    if name == "log" and fam != "mla":
        # every token whose KV was computed: each prompt, and each
        # generated token (the last one's step runs too)
        assert s["log_appends"] == sum(PROMPTS) + MAX_NEW * len(PROMPTS)
    if name == "kvhybrid" and fam != "mla":
        assert s["log_appends"] + s["page_appends"] == \
            sum(PROMPTS) + MAX_NEW * len(PROMPTS)
    assert s["fused_steps"] == (s["sched_ticks"] if fuse else 0)


@pytest.mark.parametrize("fam", ["dense", "int8"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", ENGINES)
def test_tight_budget_preempts_like_jax(name, fuse, fam):
    """A hot-window total (log, kvhybrid) or HBM working set (paged host
    mode) of a few tokens a row: rows preempt to disk and restore, their
    dense rows (int8: codes and scales) through host memory. An MLA row
    mirrors nothing, so no budget binds for it, in either package."""
    hbm = (30 if name != "paged" else 6 * PAGE_TOKENS) * token_bytes(fam)
    s = serve_both(fam, name, hbm=hbm, fuse=fuse)
    assert s["preempts"] > 0 and s["restores"] == s["preempts"]
    assert s["restore_in_bytes"] == s["preempt_out_bytes"] > 0


@pytest.mark.parametrize("fam", FAMS)
def test_speculative_mirror_matches_jax(fam):
    """``speculate_k`` 3 on ``log``: drafts ride the mirror's fused step;
    rejected tails never reach the mirror (truncated transfers)."""
    s = serve_both(fam, "log", k=3)
    assert s["spec_proposed"] > 0


def test_crash_and_journal_recovery_on_log_match_jax():
    """A crash at tick 4 on ``log``, recovered by a fresh engine sharing
    the journal: the same tokens as the uninterrupted run, and the
    recovering engine's stats equal the JAX one's."""
    want = serve_both("dense", "log")
    out = {}
    for pkg in ("jax", "torch"):
        side = Side(pkg, "dense")
        journal = side.journal()
        reqs = side.requests(prompts(0, PROMPTS), MAX_NEW)
        with pytest.raises(side.faults.CrashFault):
            engine(pkg, "dense", "log", journal=journal,
                   plan=side.plan(crash_at_tick=4)).generate(reqs)
        reqs = side.requests(prompts(0, PROMPTS), MAX_NEW)
        eng = engine(pkg, "dense", "log", journal=journal)
        eng.recover(reqs)
        out[pkg] = (tokens(reqs), eng.stats())
    assert out["torch"][0] == out["jax"][0]
    assert not stats_mismatch(out["torch"][1], out["jax"][1])
    ref = Side("torch", "dense").requests(prompts(0, PROMPTS), MAX_NEW)
    engine("torch", "dense", "log").generate(ref)
    assert out["torch"][0] == tokens(ref)
    assert out["torch"][1]["sched_ticks"] < want["sched_ticks"]


def test_pooled_rule_matches_jax():
    """``paged_decode=True`` on a pool-less engine raises ``ValueError``;
    auto picks the pool when the budget fits and the mirror when it does
    not, as in JAX."""
    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError, match="paged_decode=True"):
            engine(pkg, "dense", "log", paged_decode=True)
        group = models("dense")[2].cache_descriptor(PAGE_TOKENS) \
            .page_group_bytes
        small = engine(pkg, "dense", "paged", paged_decode=None,
                       hbm=(MAX_LEN // PAGE_TOKENS) * group)
        big = engine(pkg, "dense", "paged", paged_decode=None)
        assert (small.pooled, big.pooled) == (False, True)
        assert big.prefix_cache is None and not engine(
            pkg, "dense", "log", paged_decode=None).pooled


# ----------------------------------------------------------- step_ragged
def _dense_cache(fam, rng, B, T):
    """A random dense cache row batch in the family's planes, fp32 (int8:
    random codes and positive bf16 scales)."""
    cfg = models(fam)[2].cfg
    Lyr = cfg.num_layers
    if fam == "mla":
        m = cfg.mla
        shapes = {"c": (m.kv_lora_rank,), "kr": (m.qk_rope_head_dim,)}
    else:
        shapes = {"k": (cfg.num_kv_heads, cfg.head_dim),
                  "v": (cfg.num_kv_heads, cfg.head_dim)}
    out = {}
    for n, sh in shapes.items():
        x = rng.standard_normal((Lyr, B, T) + sh).astype(np.float32)
        if fam == "int8":
            out[n] = rng.integers(-127, 128, x.shape).astype(np.int8)
            out[n + "_scale"] = (rng.random(x.shape[:-1]) * 0.05
                                 + 0.01).astype(np.float32)
        else:
            out[n] = x
    return out


def _jax_cache(np_cache):
    return {n: (jnp.asarray(a, jnp.bfloat16) if n.endswith("_scale")
                else jnp.asarray(a)) for n, a in np_cache.items()}


def _torch_cache(np_cache):
    return {n: (torch.from_numpy(a.copy()).to(torch.bfloat16)
                if n.endswith("_scale") else torch.from_numpy(a.copy()))
            for n, a in np_cache.items()}


@pytest.mark.parametrize("fam", FAMS)
def test_step_ragged_matches_jax(fam):
    """Mixed rows in one mirror step — a padding row (q_len 0), a decode
    row (q_len 1) and a chunk row (q_len 5) — against the JAX step: logits
    of every valid slot and the written cache planes within the ragged
    entries' tolerance (int8 codes exact), and the padding row's cache
    untouched."""
    jmodel, jparams, tmodel = models(fam)
    rng = np.random.default_rng(3)
    T = 24
    np_cache = _dense_cache(fam, rng, 3, T)
    ctx = np.array([0, 6, 11], np.int32)
    qls = np.array([0, 1, 5], np.int32)
    toks = rng.integers(0, 512, (3, 8)).astype(np.int32)
    jc = {"pos": jnp.asarray(ctx), **_jax_cache(np_cache)}
    tc = {"pos": torch.from_numpy(ctx), **_torch_cache(np_cache)}
    jlog, jout = jmodel.step_ragged(jparams, jc, jnp.asarray(toks),
                                    jnp.asarray(ctx), jnp.asarray(qls))
    tlog, tout = tmodel.step_ragged(tc, torch.from_numpy(toks),
                                    torch.from_numpy(ctx),
                                    torch.from_numpy(qls))
    for b, q in enumerate(qls):
        np.testing.assert_allclose(tlog[b, :q].numpy(),
                                   np.asarray(jlog[b, :q]),
                                   atol=1e-4, rtol=4e-5)
    for n in np_cache:
        got, want = tout[n].float().numpy(), np.asarray(
            jout[n].astype(jnp.float32))
        assert tout[n] is tc[n]                       # written in place
        if fam == "int8" and not n.endswith("_scale"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=4e-5)
        # row 0 (q_len 0) wrote nothing
        np.testing.assert_array_equal(got[:, 0], _torch_cache(
            np_cache)[n][:, 0].float().numpy())
    assert tout["pos"].tolist() == [0, 7, 16]


@pytest.mark.parametrize("fam", FAMS)
def test_step_ragged_at_qlen1_is_decode_step(fam):
    """Every row at q_len 1: the same logits and cache as ``decode_step``
    on the same inputs, bit for bit."""
    _, _, tmodel = models(fam)
    rng = np.random.default_rng(4)
    np_cache = _dense_cache(fam, rng, 3, 16)
    pos = np.array([3, 9, 15], np.int32)
    toks = rng.integers(0, 512, (3, 1)).astype(np.int32)
    a = {"pos": torch.from_numpy(pos), **_torch_cache(np_cache)}
    b = {"pos": torch.from_numpy(pos), **_torch_cache(np_cache)}
    la, oa = tmodel.step_ragged(a, torch.from_numpy(toks),
                                torch.from_numpy(pos),
                                torch.ones(3, dtype=torch.int32))
    lb, ob = tmodel.decode_step(b, torch.from_numpy(toks),
                                torch.from_numpy(pos))
    assert torch.equal(la, lb)
    for n in list(np_cache) + ["pos"]:
        assert torch.equal(oa[n], ob[n]), n
