"""The port's int8 and MLA cache families against the JAX package's.

* the family predicates of ``descriptor_for`` pick the JAX package's
  family for every config family and KV dtype (or raise for a family still
  to be ported);
* ``deepseek-v2-236b-noexperts`` is the JAX DeepSeek-V2 config with its
  experts removed, field for field;
* ``quantize_kv`` gives the JAX int8 codes and bf16 scales;
* ``prefill``, ``decode_step``, ``decode_step_paged`` and
  ``step_paged_ragged`` match the JAX ``LM``'s with the JAX weights, on
  ``internlm2-1.8b-smoke`` with an int8 cache and on the MLA smoke config
  (logits within 1e-4, fp32);
* serving: ``generate()`` is token-identical to JAX
  ``generate_sequential`` and mirror-free, and a chunked schedule on a
  pool tight enough to preempt keeps the tokens and moves the same bytes,
  plane by plane, as the JAX engine's run of the same schedule;
* a chunked int8 prompt gives JAX's chunked ``generate()`` tokens, and so
  does the sequential reference that splits the prompt the same way (its
  later chunks attend over quantized K/V); JAX's one-shot reference does
  not.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.engines.desc import descriptor_for as jax_descriptor_for
from repro.core.engines import EngineSpec as JaxEngineSpec
from repro.models import build_model
from repro.models.attention import quantize_kv as jax_quantize_kv
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.core.engines import EngineSpec
from repro_torch.core.engines.desc import PLANE_STAT_NAMES, descriptor_for
from repro_torch.models import LM, params_from_jax
from repro_torch.models.attention import quantize_kv
from repro_torch.serving import Request, ServeConfig, ServingEngine

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

LOGIT_ATOL = 1e-4
MLA_ARCH = "deepseek-v2-236b-noexperts-smoke"
# family → (port arch, JAX arch, kv_cache_dtype, JAX config edit)
FAMILIES = {
    "int8": ("internlm2-1.8b-smoke", "internlm2-1.8b-smoke", "int8", {}),
    "mla": (MLA_ARCH, "deepseek-v2-236b-smoke", "native",
            {"family": "attn_dense", "moe": None}),
}


# ------------------------------------------------------- descriptors, config
# (port config, JAX config) of each config family
def _family_configs():
    dense = get_config("internlm2-1.8b-smoke")
    mla = get_config(MLA_ARCH)
    return {
        "dense": (dense, jax_get_config("internlm2-1.8b-smoke")),
        "mla": (mla, dataclasses.replace(
            jax_get_config("deepseek-v2-236b-smoke"), family="attn_dense",
            moe=None)),
        "mla+moe": (get_config("deepseek-v2-236b-smoke"),
                    jax_get_config("deepseek-v2-236b-smoke")),
        "moe": (get_config("arctic-480b-smoke"),
                jax_get_config("arctic-480b-smoke")),
        "ssm": (get_config("mamba2-1.3b-smoke"),
                jax_get_config("mamba2-1.3b-smoke")),
        "hybrid": (get_config("zamba2-1.2b-smoke"),
                   jax_get_config("zamba2-1.2b-smoke")),
        "vlm": (get_config("llava-next-mistral-7b-smoke"),
                jax_get_config("llava-next-mistral-7b-smoke")),
        "encdec": (get_config("seamless-m4t-large-v2-smoke"),
                   jax_get_config("seamless-m4t-large-v2-smoke")),
    }


@pytest.mark.parametrize("kd", ["native", "int8"])
@pytest.mark.parametrize("fam", ["dense", "mla", "mla+moe", "moe", "ssm",
                                 "hybrid", "vlm", "encdec"])
def test_descriptor_family_matches_jax(fam, kd):
    """The port picks the JAX family (int8 only for non-MoE, non-MLA
    attention, the VLM's decoder included; SSM state rows whatever the KV
    dtype; no descriptor for the hybrid or the encoder-decoder)."""
    cfg, jcfg = _family_configs()[fam]
    jdesc = jax_descriptor_for(jcfg, kd)
    desc = descriptor_for(cfg, kd)
    if fam == "ssm":
        # the JAX planes: conv in the compute dtype, ssm in float32, both
        # state rows; no pages and no kernel
        assert desc.family == jdesc.family == "ssm"
        assert desc.kernel == jdesc.kernel == "none"
        assert not desc.has_pages and desc.has_state
        assert [(p.name, p.shape, p.dtype, p.kind)
                for p in desc.seq_planes] == \
            [(p.name, p.shape, p.dtype, p.kind) for p in jdesc.seq_planes]
        assert desc.seq_state_bytes == jdesc.seq_state_bytes
        return
    if fam in ("hybrid", "encdec"):
        assert jdesc is None and desc is None
        return
    assert desc.family == jdesc.family and desc.kernel == jdesc.kernel
    if fam in ("dense", "mla", "mla+moe", "moe", "vlm"):  # same config
        assert [(p.name, p.shape, p.dtype, p.kind)
                for p in desc.paged_planes] == \
            [(p.name, p.shape, p.dtype, p.kind) for p in jdesc.paged_planes]
        assert desc.page_group_bytes == jdesc.page_group_bytes


@pytest.mark.parametrize("suffix", ["", "-smoke"])
def test_mla_config_is_jax_deepseek_without_experts(suffix):
    cfg = get_config("deepseek-v2-236b-noexperts" + suffix)
    jcfg = dataclasses.replace(jax_get_config("deepseek-v2-236b" + suffix),
                               family="attn_dense", moe=None)
    for f in dataclasses.fields(cfg):
        if f.name == "name":
            continue
        if not hasattr(jcfg, f.name):         # the port's own field (YaRN)
            assert getattr(cfg, f.name) == f.default, f.name
            continue
        mine, ref = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name in ("mla", "frontend"):     # the port's own dataclasses
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        else:
            assert mine == ref, f.name
    assert cfg.padded_vocab == jcfg.padded_vocab


def test_quantize_kv_matches_jax():
    """Same int8 codes and bf16 scales as JAX on seeded inputs, ties of
    round-half-to-even and an all-zero head included."""
    rng = np.random.default_rng(40)
    x = rng.standard_normal((3, 5, 4, 32)).astype(np.float32) * 3
    x[0, 0, 0, :4] = [127.0, 2.5, -3.5, 0.5]      # scale 1: exact ties
    x[0, 1, 1] = 0.0                              # floored scale
    q, s = quantize_kv(torch.from_numpy(x))
    jq, js = jax_quantize_kv(jnp.asarray(x))
    jq = np.asarray(jq)
    js = np.asarray(js.astype(jnp.float32))
    differ = np.argwhere(q.numpy() != jq)
    assert differ.size == 0, f"codes differ at {differ.tolist()}"
    np.testing.assert_array_equal(s.float().numpy(), js)
    assert q[0, 0, 0, :4].tolist() == [127, 2, -4, 0]


# ------------------------------------------------------------- model steps
def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


_MODELS: dict = {}


def _models(fam):
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


def _close_planes(fam, got: dict, want: dict):
    """Cache planes agree: int8 codes within one step (a product that
    lands on a rounding tie may round either way) with scales within a
    bf16 ulp; float planes within 1e-5."""
    for name, arr in got.items():
        ref = _f32(want[name])
        if arr.dtype == torch.int8:
            assert np.abs(arr.numpy().astype(int) - ref.astype(int)).max() \
                <= 1, name
        elif name.endswith("scale"):
            np.testing.assert_allclose(arr.float().numpy(), ref, rtol=2 ** -8,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(arr.float().numpy(), ref, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_prefill_and_dense_decode_match_jax(fam):
    jmodel, jparams, tmodel = _models(fam)
    names = [p.name for p in tmodel.cache_descriptor().paged_planes]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, (2, 11)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 16)
    tl, tc = tmodel.prefill(_t(toks), 16)
    np.testing.assert_allclose(tl.numpy(), _f32(jl), atol=LOGIT_ATOL)
    assert sorted(k for k in tc if k != "pos") == sorted(names)
    _close_planes(fam, {n: tc[n] for n in names}, jc)
    nxt = rng.integers(0, 512, (2, 1)).astype(np.int32)
    pos = np.array([11, 11], np.int32)
    jl2, jc2 = jmodel.decode_step(jparams, jc, jnp.asarray(nxt),
                                  jnp.asarray(pos))
    tl2, tc2 = tmodel.decode_step(tc, _t(nxt), _t(pos))
    np.testing.assert_allclose(tl2.numpy(), _f32(jl2), atol=LOGIT_ATOL)
    _close_planes(fam, {n: tc2[n] for n in names}, jc2)
    assert tc2["pos"].tolist() == [12, 12]


def _pools(tmodel, rng, P=12, T=4):
    """Random pool planes in the family's layout: int8 codes with bf16
    scales, or float planes."""
    desc = tmodel.cache_descriptor(T)
    pools = {}
    for p in desc.paged_planes:
        shape = (desc.num_layers, P, T) + p.shape
        if p.dtype == "int8":
            pools[p.name] = rng.integers(-127, 128, shape).astype(np.int8)
        elif p.kind == "scale":
            pools[p.name] = (rng.random(shape) * 0.1 + 0.01).astype(
                np.float32)
        else:
            pools[p.name] = rng.standard_normal(shape).astype(np.float32)
    return desc, pools


def _both_caches(desc, pools, **extra):
    jc = {k: jnp.asarray(v) for k, v in extra.items()}
    tc = {k: _t(v) for k, v in extra.items()}
    for p in desc.paged_planes:
        arr = pools[p.name]
        if p.dtype == "bfloat16":
            jc["pool_" + p.name] = jnp.asarray(arr, jnp.bfloat16)
            tc["pool_" + p.name] = torch.from_numpy(arr).to(torch.bfloat16)
        else:
            jc["pool_" + p.name] = jnp.asarray(arr)
            tc["pool_" + p.name] = torch.from_numpy(arr.copy())
    return jc, tc


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_paged_decode_matches_jax(fam):
    jmodel, jparams, tmodel = _models(fam)
    rng = np.random.default_rng(2)
    desc, pools = _pools(tmodel, rng)
    tbl = np.array([[3, 7, 1, 0], [5, 2, 9, 11]], np.int32)
    pos = np.array([6, 13], np.int32)
    toks = rng.integers(0, 512, (2, 1)).astype(np.int32)
    jc, tc = _both_caches(desc, pools, pos=pos, block_table=tbl)
    jlog, jout = jmodel.decode_step_paged(jparams, jc, jnp.asarray(toks),
                                          jnp.asarray(pos))
    tlog, tout = tmodel.decode_step_paged(tc, _t(toks), _t(pos))
    np.testing.assert_allclose(tlog.numpy(), _f32(jlog), atol=LOGIT_ATOL)
    names = ["pool_" + p.name for p in desc.paged_planes]
    for n in names:
        assert tout[n] is tc[n]              # scattered in place
    _close_planes(fam, {n: tout[n] for n in names}, jout)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_ragged_paged_step_matches_jax(fam):
    """Mixed rows in one fused step: a padding row (q_len 0), a decode row
    (q_len 1) and a prefill-chunk row (q_len 5, crossing a page)."""
    jmodel, jparams, tmodel = _models(fam)
    rng = np.random.default_rng(3)
    desc, pools = _pools(tmodel, rng)
    tbl = np.array([[0, 0, 0, 0], [3, 7, 1, 0], [5, 2, 9, 11]], np.int32)
    ctx = np.array([0, 6, 7], np.int32)
    qls = np.array([0, 1, 5], np.int32)
    toks = rng.integers(0, 512, (3, 8)).astype(np.int32)
    jc, tc = _both_caches(desc, pools, block_table=tbl)
    jlog, jout = jmodel.step_paged_ragged(jparams, jc, jnp.asarray(toks),
                                          jnp.asarray(ctx), jnp.asarray(qls))
    tlog, tout = tmodel.step_paged_ragged(tc, _t(toks), _t(ctx), _t(qls))
    for b, q in enumerate(qls):
        np.testing.assert_allclose(tlog[b, :q].numpy(), _f32(jlog[b, :q]),
                                   atol=LOGIT_ATOL)
    names = ["pool_" + p.name for p in desc.paged_planes]
    _close_planes(fam, {n: tout[n] for n in names}, jout)
    for n in names:       # the padding row touched nothing (page 0)
        np.testing.assert_array_equal(tout[n][:, 0].float().numpy(),
                                      _f32(jc[n][:, 0]))
    assert tout["pos"].tolist() == [0, 7, 12]


# ----------------------------------------------------------------- serving
MAX_LEN, PAGE_TOKENS, PROMPT_LENS, MAX_NEW = 24, 4, (8, 12, 8), 6


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n, dtype=np.int32) for n in PROMPT_LENS]


def _torch_engine(model, *, hbm_bytes=64 << 20, chunk=None, fuse=True):
    return ServingEngine(model, ServeConfig(
        max_len=MAX_LEN, page_tokens=PAGE_TOKENS,
        engine_spec=EngineSpec(engine="paged", kv_hbm_bytes=hbm_bytes),
        max_batch_seqs=4, prefill_chunk_tokens=chunk, fuse_ticks=fuse),
        device="cpu")


def _jax_run(fam, method, engine, **kw):
    jmodel, jparams, _ = _models(fam)
    reqs = [JaxRequest(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts())]
    hbm = kw.pop("hbm_bytes", 64 << 20)
    eng = JaxServingEngine(jmodel, jparams, JaxServeConfig(
        max_len=MAX_LEN, page_tokens=PAGE_TOKENS,
        engine_spec=JaxEngineSpec(engine=engine, kv_hbm_bytes=hbm,
                                  kv_hot_window=8, drain_shards=2),
        max_batch_seqs=4, **kw))
    getattr(eng, method)(reqs)
    return [r.generated for r in reqs], eng.stats()


def _torch_requests():
    return [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts())]


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_pooled_fused_generate_matches_jax_sequential(fam):
    _, _, tmodel = _models(fam)
    want, _ = _jax_run(fam, "generate_sequential", "log",
                       paged_decode=False)
    reqs = _torch_requests()
    eng = _torch_engine(tmodel)
    assert eng.pooled and eng.fused
    eng.generate(reqs)
    assert [r.generated for r in reqs] == want
    s = eng.stats()
    assert s["mirror_d2h_bytes"] == 0
    assert s["step_calls"] == s["sched_ticks"] == s["fused_steps"]
    seq = _torch_requests()
    eng = _torch_engine(tmodel)
    eng.generate_sequential(seq)
    assert [r.generated for r in seq] == want
    # the reference mirrors fp16 tokens of an int8 cache (counted, not
    # appended to the int8 pool); an MLA cache has nothing to mirror
    assert (eng.stats()["mirror_d2h_bytes"] > 0) == (fam == "int8")
    assert eng.stats()["pool_appends"] == 0


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_chunked_tight_pool_matches_jax_plane_counters(fam):
    """Chunked prefill (5-token chunks) on an 8-page pool: rows preempt and
    pages spill, the tokens do not move, and every per-plane spill/fault
    byte counter equals the JAX engine's for the same schedule."""
    _, _, tmodel = _models(fam)
    budget = 8 * tmodel.cache_descriptor(PAGE_TOKENS).page_group_bytes
    want, _ = _jax_run(fam, "generate_sequential", "log",
                       paged_decode=False)
    reqs = _torch_requests()
    eng = _torch_engine(tmodel, hbm_bytes=budget, chunk=5)
    eng.generate(reqs)
    assert [r.generated for r in reqs] == want
    s = eng.stats()
    assert s["preempts"] >= 1 and s["pool_page_spills"] >= 1, s
    assert s["mirror_d2h_bytes"] == 0
    _, js = _jax_run(fam, "generate", "paged", hbm_bytes=budget,
                     prefill_chunk_tokens=5)
    keys = ["pool_page_spills", "pool_faults", "pool_d2h_bytes",
            "pool_h2d_bytes", "preempts", "restores", "sched_ticks"]
    keys += [f"pool_{d}_bytes_{p}" for d in ("d2h", "h2d")
             for p in PLANE_STAT_NAMES]
    for key in keys:
        assert s[key] == js[key], (key, s[key], js[key])
    planes = [p.name for p in tmodel.cache_descriptor().paged_planes]
    assert all(s[f"pool_d2h_bytes_{p}"] > 0 for p in planes)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_unfused_pooled_path_matches_reference(fam):
    """``fuse_ticks=False``: chunks run token by token through the family's
    decode entry — same tokens, still mirror-free."""
    _, _, tmodel = _models(fam)
    want, _ = _jax_run(fam, "generate_sequential", "log",
                       paged_decode=False)
    reqs = _torch_requests()
    eng = _torch_engine(tmodel, chunk=5, fuse=False)
    eng.generate(reqs)
    assert [r.generated for r in reqs] == want
    assert eng.stats()["mirror_d2h_bytes"] == 0


def test_int8_chunked_prefill_matches_chunk_aware_reference():
    """An int8 prompt split into 128-token chunks: its later chunks attend
    over the QUANTIZED K/V of earlier chunks. The JAX package's own pooled
    ``generate()`` at the same chunk is the witness, on the same weights
    and requests: the port's ``generate()`` and
    ``chip_smoke.chunked_sequential`` (the reference of ``chip_smoke.py``'s
    int8 parity phase: first chunk prefilled, the rest of the prompt
    through the decode step) equal it token for token. On this request
    JAX's one-shot ``generate_sequential()`` differs from JAX's chunked
    ``generate()`` at the first token, at a top-2 margin of 3% of the
    logit std: another function, not a near-tie."""
    jmodel, jparams, tmodel = _models("int8")
    dev = torch.device("cpu")

    def reqs():           # one request, 215 prompt tokens: two chunks
        return cs.requests(1, 129, 300, 4, tmodel.cfg.vocab_size, 43)

    def jax_reqs():
        return [JaxRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
                for r in reqs()]

    jax_chunked = jax_reqs()
    JaxServingEngine(jmodel, jparams, JaxServeConfig(
        max_len=560, page_tokens=16, max_batch_seqs=8,
        prefill_chunk_tokens=cs.CHUNK,
        engine_spec=JaxEngineSpec(engine="paged", kv_hbm_bytes=4 << 30)
    )).generate(jax_chunked)
    want = [r.generated for r in jax_chunked]
    got = reqs()
    eng = cs.engine(tmodel, dev, hbm=4 << 30)
    eng.generate(got)
    assert eng.stats()["sched_prefill_chunks"] >= 1
    assert [r.generated for r in got] == want
    ref = cs.chunked_sequential(torch, tmodel, reqs(), cs.CHUNK)
    assert [r.generated for r in ref] == want
    # JAX's one-shot reference (the port's equals it) is another function
    one_shot = jax_reqs()
    JaxServingEngine(jmodel, jparams, JaxServeConfig(
        max_len=560, page_tokens=16, max_batch_seqs=8,
        engine_spec=JaxEngineSpec(engine="log", kv_hbm_bytes=4 << 30,
                                  kv_hot_window=8, drain_shards=2),
        paged_decode=False)).generate_sequential(one_shot)
    port_one_shot = cs.engine(tmodel, dev, hbm=4 << 30).generate_sequential(
        reqs())
    assert [r.generated for r in port_one_shot] == \
        [r.generated for r in one_shot]
    assert one_shot[0].generated[0] != want[0][0]
    margin, std = cs.reference_margin(torch, tmodel, port_one_shot[0], 0,
                                      None, 560)
    assert margin > 1e-2 * std, (margin, std)
