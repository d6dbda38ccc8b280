"""Serving the state-space families through the port against the JAX
package, fp32 on the CPU.

The scenarios of ``test_families_match_sequential_for_any_schedule``
(``tests/test_core_properties.py``) for the ``ssm`` family, as
parametrised cases: ``mamba2-1.3b-smoke`` on ``paged`` (pooled state
rows, fused, mirror-free), ``log`` and ``kvhybrid`` (the dense mirror,
fused), prefill chunks None/5, ``speculate_k`` 0/2 and
``max_batch_seqs`` 1–3, each with its own arrival order, seed and
length. The port gives JAX's tokens and JAX's whole ``stats()`` dict,
and both give the sequential reference's tokens. Then the Zamba2 hybrid
(cut to 5 layers, 2 shared blocks, nonzero LoRA) on each engine — no
cache descriptor, so unfused on the mirror and nothing mirrored, in both
packages — and a state-row budget of 2 rows that preempts.
"""
import itertools

import numpy as np
import pytest

from repro.core.engines import EngineSpec as JaxEngineSpec
from torch_serving_pairs import (EngineSpec, JaxRequest, JaxServeConfig,
                                 JaxServingEngine, Request, ServeConfig,
                                 ServingEngine, arch_models, hybrid_models,
                                 stats_mismatch, tokens)
from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)

SSM_ARCH = "mamba2-1.3b-smoke"
ENGINES = ("paged", "log", "kvhybrid")
PERMS = list(itertools.permutations(range(3)))
# (engine, chunk, speculate_k, max_batch_seqs), each case with its own
# arrival order, seed and max_new
CASES = [(e, c, k, m) for e in ENGINES for c in (None, 5) for k in (0, 2)
         for m in (1, 2, 3)]
_REF: dict = {}


def _prompts(seed, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (6, 9, 7)[i], dtype=np.int32)
            for i in range(3)]


def _engine(pkg, models_, name, *, chunk=None, k=0, mbs=2, hbm=64 << 20):
    jmodel, jparams, tmodel = models_
    spec = dict(engine=name, kv_hbm_bytes=hbm, kv_hot_window=4,
                drain_shards=2)
    kw = dict(max_len=16, page_tokens=4, max_batch_seqs=mbs,
              prefill_chunk_tokens=chunk, speculate_k=k)
    if pkg == "jax":
        return JaxServingEngine(jmodel, jparams, JaxServeConfig(
            engine_spec=JaxEngineSpec(**spec), **kw)), JaxRequest
    return ServingEngine(tmodel, ServeConfig(
        engine_spec=EngineSpec(**spec), **kw), device="cpu"), Request


def _serve(pkg, models_, name, perm, seed, max_new, **kw):
    eng, cls = _engine(pkg, models_, name, **kw)
    reqs = [cls(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(_prompts(seed))]
    eng.generate([reqs[i] for i in perm])
    assert all(r.done for r in reqs)
    return tokens(reqs), eng.stats(), eng


def _sequential(key, models_, seed, max_new):
    """The JAX sequential mirrored reference's tokens (memoized)."""
    if (key, seed, max_new) not in _REF:
        eng, cls = _engine("jax", models_, "log")
        reqs = [cls(rid=i, prompt=p.copy(), max_new=max_new)
                for i, p in enumerate(_prompts(seed))]
        eng.generate_sequential(reqs)
        _REF[(key, seed, max_new)] = tokens(reqs)
    return _REF[(key, seed, max_new)]


def _assert_pair(got, want):
    (tt, ts, _), (jt, js, _) = got, want
    assert tt == jt
    bad = stats_mismatch(ts, js)
    assert not bad, f"port != JAX (port, jax): {bad}"


@pytest.mark.parametrize("name,chunk,k,mbs", CASES)
def test_ssm_serving_matches_jax_and_sequential(name, chunk, k, mbs):
    i = CASES.index((name, chunk, k, mbs))
    perm, seed, max_new = PERMS[i % len(PERMS)], i % 3, 1 + i % 3
    models_ = arch_models(SSM_ARCH)
    kw = dict(chunk=chunk, k=k, mbs=mbs)
    want = _serve("jax", models_, name, perm, seed, max_new, **kw)
    got = _serve("torch", models_, name, perm, seed, max_new, **kw)
    _assert_pair(got, want)
    assert got[0] == _sequential("ssm", models_, seed, max_new)
    eng, stats = got[2], got[1]
    assert stats["mirror_d2h_bytes"] == 0
    assert eng.fused and eng.pooled == (name == "paged")
    if eng.pooled:
        assert eng.desc.family == "ssm" and eng.tiered.pool_pages == 0


@pytest.mark.parametrize("chunk", [None, 5])
@pytest.mark.parametrize("name", ENGINES)
def test_hybrid_serving_matches_jax_and_sequential(name, chunk):
    models_ = hybrid_models()
    perm, seed = PERMS[ENGINES.index(name) + 2 * (chunk is None)], 1
    want = _serve("jax", models_, name, perm, seed, 3, chunk=chunk)
    got = _serve("torch", models_, name, perm, seed, 3, chunk=chunk)
    _assert_pair(got, want)
    assert got[0] == _sequential("hybrid", models_, seed, 3)
    eng, stats = got[2], got[1]
    # no descriptor: unfused on the mirror, and the shared-attention KV
    # (shared_k/shared_v, no "k") is never mirrored
    assert not eng.fused and not eng.pooled and eng.desc is None
    assert stats["mirror_d2h_bytes"] == 0 and stats["fused_steps"] == 0


@pytest.mark.parametrize("chunk,k", [(None, 0), (5, 2)])
def test_ssm_state_rows_preempt_on_a_two_row_budget(chunk, k):
    """A budget of 2 state rows for 3 requests: the pooled engine preempts
    rows (their state spilled whole, per plane) and restores them, token
    for token and counter for counter as JAX does."""
    models_ = arch_models(SSM_ARCH)
    desc = models_[2].cache_descriptor(4)
    kw = dict(chunk=chunk, k=k, mbs=3, hbm=2 * desc.seq_state_bytes)
    want = _serve("jax", models_, "paged", (0, 1, 2), 2, 4, **kw)
    got = _serve("torch", models_, "paged", (0, 1, 2), 2, 4, **kw)
    _assert_pair(got, want)
    assert got[0] == _sequential("ssm", models_, 2, 4)
    s = got[1]
    assert s["preempts"] > 0 and s["restores"] == s["preempts"]
    per_row = {p.name: desc.num_layers * p.entry_bytes
               for p in desc.seq_planes}
    for plane, nbytes in per_row.items():
        assert s[f"pool_d2h_bytes_{plane}"] == s["preempts"] * nbytes
        assert s[f"pool_h2d_bytes_{plane}"] == s["restores"] * nbytes
    assert s["mirror_d2h_bytes"] == 0


def test_hybrid_never_preempts_on_a_tight_budget():
    """Nothing of a hybrid row lands in the tiered engine, so a budget of
    a few bytes never presses: no preempts, in both packages."""
    models_ = hybrid_models()
    want = _serve("jax", models_, "log", (2, 0, 1), 0, 3, mbs=3, hbm=64)
    got = _serve("torch", models_, "log", (2, 0, 1), 0, 3, mbs=3, hbm=64)
    _assert_pair(got, want)
    assert got[1]["preempts"] == 0 and got[1]["sched_preempts"] == 0
