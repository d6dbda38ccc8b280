"""Shared harness of the serving-feature parity tests: the JAX package's
``ServingEngine`` and the port's, on the same weights and the same
schedule.

A scenario is a function of one package's :class:`Side` (engine, request,
fault-plan and journal factories) that drives that package's serving
surface and returns what it observed. :func:`pair` runs it on both
packages (the JAX side once per family and scenario, memoized) so a test
can hold the port's tokens and counters to the JAX engine's.

Cache families, each on its smoke config with the JAX ``LM.init`` weights
carried across (fp32): ``dense`` (``internlm2-1.8b-smoke``), ``int8`` (the
same with an int8 KV pool) and ``mla`` (DeepSeek-V2 without experts).
:func:`arch_models` and :func:`serve_arch` do the same for any registered
``-smoke`` config, a MoE one at any capacity factor; :func:`hybrid_models`
for a Zamba2 cut to show its structure (two segments, both shared blocks,
a tail layer, a nonzero LoRA).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.engines import EngineSpec as JaxEngineSpec
from repro.models import build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import faults as jax_faults
from repro.serving.journal import ServingJournal as JaxServingJournal
from repro_torch.configs import get_config
from repro_torch.core.engines import EngineSpec
from repro_torch.core.engines.desc import PLANE_STAT_NAMES
from repro_torch.models import LM, params_from_jax
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.serving import faults
from repro_torch.serving.journal import ServingJournal

MAX_LEN = 48
PAGE_TOKENS = 4
# family → (port arch, JAX arch, kv_cache_dtype, JAX config edit)
FAMILIES = {
    "dense": ("internlm2-1.8b-smoke", "internlm2-1.8b-smoke", "native", {}),
    "int8": ("internlm2-1.8b-smoke", "internlm2-1.8b-smoke", "int8", {}),
    "mla": ("deepseek-v2-236b-noexperts-smoke", "deepseek-v2-236b-smoke",
            "native", {"family": "attn_dense", "moe": None}),
}
# counters the port must move exactly as the JAX engine does
COUNTERS = (
    "prefix_hits", "prefix_tokens_reused", "cow_copies", "shared_pages",
    "spec_proposed", "spec_accepted", "pool_page_spills", "pool_faults",
    "pool_appends", "pool_d2h_bytes", "pool_h2d_bytes", "preempts",
    "restores", "host_pages_lost", "transfer_retries", "transfer_failures",
    "retried_faults", "prefetch_hits", "async_spills", "tiering_degraded",
    "sched_ticks", "sched_spliced", "sched_rows_shed", "sched_decode_rows",
    "sched_prefill_chunks", "prefill_calls", "step_calls",
) + tuple(f"pool_{d}_bytes_{p}" for d in ("d2h", "h2d")
          for p in PLANE_STAT_NAMES)
# step counters one engine has and the other has no twin of: the port's
# padded slots, real tokens and logit bytes of its steps and its drop-free
# MoE work (no JAX config is drop-free), and the JAX engine's count of
# distinct step shapes (its jit compiles; PyTorch compiles nothing)
PORT_ONLY = ("step_slots", "step_tokens", "logit_bytes", "expert_rows",
             "routed_slots", "experts_run")
JAX_ONLY = ("step_compiles", "step_cache_hits")

_MODELS: dict = {}


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """The port's CPU steps here are tiny ops: one intra-op thread each,
    as many threads spin against the other test workers on a loaded
    machine (a test module picks this up by importing it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(fam):
    """(JAX model, JAX params, port model) of a family, with the JAX
    weights carried across."""
    if fam not in _MODELS:
        arch, jarch, kd, edit = FAMILIES[fam]
        jcfg = dataclasses.replace(jax_get_config(jarch), **edit)
        jmodel = build_model(jcfg, remat=False, kv_cache_dtype=kd)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        cfg = get_config(arch)
        tmodel = LM(cfg, device="cpu", kv_cache_dtype=kd)
        tmodel.load_state_dict(params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg))
        _MODELS[fam] = (jmodel, jparams, tmodel)
    return _MODELS[fam]


_ARCH_MODELS: dict = {}


def arch_models(arch: str, capacity_factor=None):
    """(JAX model, JAX params, port model) of a registered config, with the
    JAX weights carried across; ``capacity_factor`` replaces a MoE
    config's."""
    key = (arch, capacity_factor)
    if key not in _ARCH_MODELS:
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        if capacity_factor is not None:
            jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=capacity_factor)) for c in (jcfg, cfg))
        jmodel = build_model(jcfg, remat=False)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        tmodel = LM(cfg, device="cpu")
        tmodel.load_state_dict(params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg))
        _ARCH_MODELS[key] = (jmodel, jparams, tmodel)
    return _ARCH_MODELS[key]


# Zamba2 at smoke width with the structure the smoke config hides: 5
# layers at period 2 are 2 segments and a tail of 1, and 2 shared blocks
# alternate between the segments
HYBRID_ARCH = "zamba2-1.2b-smoke"
HYBRID_LAYERS, HYBRID_SHARED = 5, 2
_HYBRID_MODELS: dict = {}


def hybrid_config(cfg):
    """``cfg`` (either package's ``zamba2-1.2b-smoke``) cut as above."""
    return dataclasses.replace(
        cfg, num_layers=HYBRID_LAYERS, hybrid=dataclasses.replace(
            cfg.hybrid, num_shared_blocks=HYBRID_SHARED))


def hybrid_models(chunk_size=512):
    """(JAX model, JAX params, port model) of the cut Zamba2, with every
    LoRA ``b`` (zeros at init) drawn from a seeded numpy normal, so an
    unfolded LoRA shows."""
    if chunk_size not in _HYBRID_MODELS:
        jcfg = hybrid_config(jax_get_config(HYBRID_ARCH))
        cfg = hybrid_config(get_config(HYBRID_ARCH))
        jmodel = build_model(jcfg, remat=False, chunk_size=chunk_size)
        npp = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
        b = npp["loras"]["b"]
        npp["loras"]["b"] = 0.2 * np.random.default_rng(4).standard_normal(
            b.shape).astype(b.dtype)
        jparams = jax.tree.map(jax.numpy.asarray, npp)
        tmodel = LM(cfg, device="cpu", chunk_size=chunk_size)
        tmodel.load_state_dict(params_from_jax(npp, cfg))
        _HYBRID_MODELS[chunk_size] = (jmodel, jparams, tmodel)
    return _HYBRID_MODELS[chunk_size]


# (KV engine, fused) runs of serve_arch: the pool and the dense mirror on
# both host-tier engines, each fused and unfused
SERVE_RUNS = tuple((name, fuse) for name in ("paged", "log", "kvhybrid")
                   for fuse in (True, False))
SERVE_IDS = [f"{n}-{'fused' if f else 'unfused'}" for n, f in SERVE_RUNS]
SERVE_PROMPTS = (8, 12, 8, 5)


def serve_arch(pkg: str, models_, name: str, fuse: bool, seq=False):
    """``generate()`` (``generate_sequential()`` with ``seq``) of four
    seeded requests on one package's engine — ``max_len`` 48, 4-token
    pages, 5-token prefill chunks, 6 new tokens. Returns (tokens,
    stats)."""
    jmodel, jparams, tmodel = models_
    spec = dict(engine=name, kv_hbm_bytes=64 << 20, kv_hot_window=8,
                drain_shards=2)
    kw = dict(max_len=MAX_LEN, page_tokens=PAGE_TOKENS, max_batch_seqs=4,
              prefill_chunk_tokens=5, fuse_ticks=fuse)
    if pkg == "jax":
        eng = JaxServingEngine(jmodel, jparams, JaxServeConfig(
            engine_spec=JaxEngineSpec(**spec), **kw))
        cls = JaxRequest
    else:
        eng = ServingEngine(tmodel, ServeConfig(
            engine_spec=EngineSpec(**spec), **kw), device="cpu")
        cls = Request
    reqs = [cls(rid=i, prompt=p.copy(), max_new=6)
            for i, p in enumerate(prompts(0, SERVE_PROMPTS))]
    (eng.generate_sequential if seq else eng.generate)(reqs)
    assert eng.pooled == (name == "paged")
    return tokens(reqs), eng.stats()


def serve_pair(arch: str, name: str, fuse: bool, capacity_factor=None):
    """:func:`serve_arch` of one schedule on both packages: asserts the
    same tokens and the same ``stats()`` dict, key for key, floats
    included. Returns (the pair's models, the tokens)."""
    pair = arch_models(arch, capacity_factor)
    jt, js = serve_arch("jax", pair, name, fuse)
    tt, ts = serve_arch("torch", pair, name, fuse)
    assert tt == jt
    bad = stats_mismatch(ts, js)
    assert not bad, f"port != JAX (port, jax): {bad}"
    # the mirror moves k/v rows; an MLA row has none, as in JAX
    mirrored = name != "paged" and pair[2].cfg.mla is None
    assert (ts["mirror_d2h_bytes"] > 0) == mirrored
    return pair, tt


def stats_mismatch(ts: dict, js: dict) -> dict:
    """The counters of the port's ``stats()`` and the JAX engine's that
    differ, key by key (a key one side lacks counts), leaving out the
    counters only one engine has."""
    ts = {k: v for k, v in ts.items() if k not in PORT_ONLY}
    js = {k: v for k, v in js.items() if k not in JAX_ONLY}
    return {k: (ts.get(k), js.get(k)) for k in set(ts) | set(js)
            if ts.get(k) != js.get(k)}


def group_bytes(fam) -> int:
    """One pool page group (all layers, all planes) of the family."""
    return models(fam)[2].cache_descriptor(PAGE_TOKENS).page_group_bytes


class Side:
    """One package's serving surface, with the same signatures on both."""

    def __init__(self, pkg: str, fam: str):
        self.pkg, self.fam = pkg, fam
        self.vocab = models(fam)[2].cfg.vocab_size
        self.faults = jax_faults if pkg == "jax" else faults

    def engine(self, *, pages=None, prefix_tokens=0, chunk=None, k=0,
               proposer=None, fuse=True, plan=None, journal=None,
               max_batch_seqs=4, async_tiering=False):
        hbm = 64 << 20 if pages is None else pages * group_bytes(self.fam)
        kw = dict(max_len=MAX_LEN, page_tokens=PAGE_TOKENS,
                  max_batch_seqs=max_batch_seqs, prefill_chunk_tokens=chunk,
                  fuse_ticks=fuse, speculate_k=k, draft_proposer=proposer,
                  fault_plan=plan, journal=journal)
        jmodel, jparams, tmodel = models(self.fam)
        if self.pkg == "jax":
            return JaxServingEngine(jmodel, jparams, JaxServeConfig(
                engine_spec=JaxEngineSpec(
                    engine="paged", kv_hbm_bytes=hbm,
                    prefix_cache_tokens=prefix_tokens,
                    async_tiering=async_tiering), **kw))
        return ServingEngine(tmodel, ServeConfig(
            engine_spec=EngineSpec(
                engine="paged", kv_hbm_bytes=hbm,
                prefix_cache_tokens=prefix_tokens,
                async_tiering=async_tiering), **kw), device="cpu")

    def request(self, rid, prompt, max_new):
        cls = JaxRequest if self.pkg == "jax" else Request
        return cls(rid=rid, prompt=np.asarray(prompt, np.int32).copy(),
                   max_new=max_new)

    def requests(self, prompts, max_new, first_rid=0):
        return [self.request(first_rid + i, p, max_new)
                for i, p in enumerate(prompts)]

    def plan(self, script=(), **kw):
        """A FaultPlan; ``script`` holds ``(tick, kind, key, value)``."""
        return self.faults.FaultPlan(
            script=tuple(self.faults.FaultEvent(*ev) for ev in script), **kw)

    def journal(self, capacity=1 << 16):
        return (JaxServingJournal if self.pkg == "jax"
                else ServingJournal)(capacity=capacity)


def prompts(seed, lens, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in lens]


_PAIRS: dict = {}


def pair(fam: str, scenario):
    """``(jax_result, port_result)`` of ``scenario`` on one family; the
    JAX side is memoized per (family, scenario)."""
    key = (fam, scenario.__name__)
    if key not in _PAIRS:
        _PAIRS[key] = scenario(Side("jax", fam))
    return _PAIRS[key], scenario(Side("torch", fam))


def tokens(reqs):
    return [[int(t) for t in r.generated] for r in reqs]


def assert_counters_equal(got: dict, want: dict, keys=COUNTERS):
    """Every counter in ``keys`` equal, and the simulated clock equal."""
    bad = {k: (got[k], want[k]) for k in keys if got[k] != want[k]}
    assert not bad, f"port != JAX (port, jax): {bad}"
    assert got["sim_time_s"] == pytest.approx(
        want["sim_time_s"], rel=1e-9)
    assert got["mirror_d2h_bytes"] == 0
