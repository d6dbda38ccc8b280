"""Prefill over more than ``chunk_size`` tokens: the port against the JAX
package, on the CPU, with the JAX ``LM.init`` weights carried across.

The JAX ``attn_train`` takes two branches past ``chunk_size``:
``chunked_attention_tri`` when S is a multiple of it (S = 48 at
``chunk_size = 16``) and ``chunked_attention`` otherwise (S = 40). The port
computes both with ``flash_attention`` — its plain version here, the CUDA
kernel on the card. MLA past ``chunk_size`` (the JAX ``mla_train``'s
``chunked_attention`` branch) runs it at MLA's qk width beside its v width,
at S = 600 and 1024 over the default 512. Logits agree within 1e-4 and
float cache planes within 1e-5 (fp32), as ``tests/test_torch_model.py``
holds the short prefill.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.engines import EngineSpec as JaxEngineSpec
from repro.models import build_model
from repro.models.attention import attn_train as jax_attn_train
from repro.models.attention import init_mla as jax_init_mla
from repro.models.attention import mla_train as jax_mla_train
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.core.engines import EngineSpec
from repro_torch.models import LM, params_from_jax
from repro_torch.kernels import flash_attention
from repro_torch.models.attention import attn_train, mla_train
from repro_torch.serving import Request, ServeConfig, ServingEngine

from test_torch_families import _close_planes

ARCH = "internlm2-1.8b-smoke"
CHUNK = 16
LOGIT_ATOL = 1e-4
# S = 48: chunked_attention_tri (48 % 16 == 0); S = 40: chunked_attention
LENGTHS = [48, 40]


class _P:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("S", LENGTHS)
def test_attn_train_matches_jax_chunked_branches(S):
    cfg = get_config(ARCH)
    jcfg = jax_get_config(ARCH)
    d, H, K, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(S)
    w = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wq", (d, H * D)), ("wk", (d, K * D)),
                      ("wv", (d, K * D)), ("wo", (H * D, d)))}
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    jout, (jk, jv) = jax_attn_train(w, jcfg, jnp.asarray(x),
                                    jnp.asarray(pos), chunk_size=CHUNK)
    out, (k, v) = attn_train(_P(**{n: torch.from_numpy(a)
                                   for n, a in w.items()}),
                             cfg, torch.from_numpy(x),
                             torch.from_numpy(pos.copy()), chunk_size=CHUNK)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=2e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)


_MODELS: dict = {}


def _models(kd):
    """(JAX model, JAX params, port model) at chunk_size 16."""
    if kd not in _MODELS:
        jmodel = build_model(jax_get_config(ARCH), remat=False,
                             chunk_size=CHUNK, kv_cache_dtype=kd)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        cfg = get_config(ARCH)
        tmodel = LM(cfg, device="cpu", chunk_size=CHUNK, kv_cache_dtype=kd)
        tmodel.load_state_dict(params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg))
        _MODELS[kd] = (jmodel, jparams, tmodel)
    return _MODELS[kd]


@pytest.mark.parametrize("kd", ["native", "int8"])
@pytest.mark.parametrize("S", LENGTHS)
def test_long_prefill_matches_jax(S, kd):
    """``LM.prefill`` logits and cache planes past ``chunk_size``, dense
    and int8 (whose prefill quantizes what ``attn_train`` returns)."""
    jmodel, jparams, tmodel = _models(kd)
    toks = np.random.default_rng(S + 1).integers(0, 512, (2, S)).astype(
        np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, S + 8)
    tl, tc = tmodel.prefill(torch.from_numpy(toks), S + 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    _close_planes(kd, {n: tc[n] for n in tmodel.plane_names}, jc)


PROMPT_LENS, MAX_NEW, MAX_LEN = (20, 37, 9), 6, 48


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 512, n, dtype=np.int32) for n in PROMPT_LENS]


@pytest.mark.parametrize("kd", ["native", "int8"])
def test_pooled_generate_with_long_prompts_matches_jax_sequential(kd):
    """Whole-prompt prefill (no ``prefill_chunk_tokens``) of prompts past
    ``chunk_size``, then fused pooled decode: token for token the JAX
    ``generate_sequential()`` at the same ``chunk_size``."""
    jmodel, jparams, tmodel = _models(kd)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=MAX_NEW)
             for i, p in enumerate(_prompts())]
    JaxServingEngine(jmodel, jparams, JaxServeConfig(
        max_len=MAX_LEN, page_tokens=4,
        engine_spec=JaxEngineSpec(engine="log", kv_hbm_bytes=64 << 20,
                                  kv_hot_window=8, drain_shards=2),
        max_batch_seqs=4, paged_decode=False)).generate_sequential(jreqs)
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts())]
    eng = ServingEngine(tmodel, ServeConfig(
        max_len=MAX_LEN, page_tokens=4,
        engine_spec=EngineSpec(engine="paged", kv_hbm_bytes=64 << 20),
        max_batch_seqs=4), device="cpu")
    assert eng.pooled and eng.fused
    eng.generate(reqs)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    s = eng.stats()
    assert s["mirror_d2h_bytes"] == 0 and s["sched_prefill_chunks"] == 0


@pytest.mark.parametrize("S", LENGTHS)
def test_attn_train_past_chunk_size_takes_rising_positions(S):
    """The flash branch's causal mask is the token order: at positions
    that rise along S (an offset of ``arange(S)``) it equals the plain
    ``full_attention`` branch and JAX; positions out of order raise."""
    cfg = get_config(ARCH)
    jcfg = jax_get_config(ARCH)
    d, H, K, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(S + 1)
    w = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wq", (d, H * D)), ("wk", (d, K * D)),
                      ("wv", (d, K * D)), ("wo", (H * D, d)))}
    tw = _P(**{n: torch.from_numpy(a) for n, a in w.items()})
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    pos = np.stack([np.arange(S), 7 + 2 * np.arange(S)]).astype(np.int32)
    out, _ = attn_train(tw, cfg, torch.from_numpy(x),
                        torch.from_numpy(pos.copy()), chunk_size=CHUNK)
    plain, _ = attn_train(tw, cfg, torch.from_numpy(x),
                          torch.from_numpy(pos.copy()), chunk_size=S)
    jout, _ = jax_attn_train(w, jcfg, jnp.asarray(x), jnp.asarray(pos),
                             chunk_size=CHUNK)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-4,
                               rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=2e-5)
    with pytest.raises(ValueError, match="rise along the sequence"):
        attn_train(tw, cfg, torch.from_numpy(x),
                   torch.from_numpy(pos[:, ::-1].copy()), chunk_size=CHUNK)


# ------------------------------------------------- MLA past chunk_size
MLA_ARCHS = ("deepseek-v2-236b-noexperts-smoke", "deepseek-v2-236b-smoke")
# past the JAX package's default chunk_size (512): not a multiple of it,
# and one that is
MLA_LENGTHS = [600, 1024]


def _jax_mla_config(arch):
    if "noexperts" in arch:       # JAX's DeepSeek-V2 without its experts
        return dataclasses.replace(
            jax_get_config(arch.replace("-noexperts", "")), name=arch,
            family="attn_dense", moe=None)
    return jax_get_config(arch)


@pytest.mark.parametrize("S", MLA_LENGTHS)
def test_mla_train_past_chunk_size_matches_jax(S):
    """``mla_train`` past ``chunk_size`` (512): the flash kernel's plain
    version at the (qk, v) width pair (48, 32) of the smoke config — (192,
    128) at full width — against the JAX ``chunked_attention`` branch, on
    the JAX ``init_mla`` weights. fp32: output atol 1e-4, rtol 2e-5;
    latent and rope key 1e-5."""
    arch = MLA_ARCHS[0]
    cfg, jcfg = get_config(arch), _jax_mla_config(arch)
    w = jax.tree.map(np.asarray, jax_init_mla(jax.random.PRNGKey(S), jcfg,
                                              jnp.float32))
    tw = _P(**{n: torch.from_numpy(np.array(a["scale"] if isinstance(
        a, dict) else a)) for n, a in w.items()})
    rng = np.random.default_rng(S)
    x = rng.standard_normal((1, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    jout, (jc, jkr) = jax_mla_train(w, jcfg, jnp.asarray(x),
                                    jnp.asarray(pos))
    before = flash_attention.launches
    out, (c, kr) = mla_train(tw, cfg, torch.from_numpy(x),
                             torch.from_numpy(pos.copy()))
    assert flash_attention.launches == before     # the CPU runs no kernel
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=2e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(kr.numpy(), np.asarray(jkr), atol=1e-5)


_MLA_MODELS: dict = {}


def _mla_models(arch):
    """(JAX model, JAX params, port model) at the default chunk_size."""
    if arch not in _MLA_MODELS:
        jmodel = build_model(_jax_mla_config(arch), remat=False)
        jparams = jmodel.init(jax.random.PRNGKey(2))
        cfg = get_config(arch)
        tmodel = LM(cfg, device="cpu")
        tmodel.load_state_dict(params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg))
        _MLA_MODELS[arch] = (jmodel, jparams, tmodel)
    return _MLA_MODELS[arch]


@pytest.mark.parametrize("S", MLA_LENGTHS)
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_prefill_past_chunk_size_matches_jax(arch, S):
    """``LM.prefill`` of a prompt past 512 tokens on both DeepSeek-V2
    smoke configs (dense FFN, and its MoE experts): the last logits within
    1e-4 and the latent cache planes ``c``/``kr`` within 1e-5 (fp32) of
    the JAX ``LM.prefill``, which runs ``chunked_attention`` there."""
    jmodel, jparams, tmodel = _mla_models(arch)
    toks = np.random.default_rng(S).integers(0, 512, (1, S)).astype(
        np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, S + 8)
    tl, tc = tmodel.prefill(torch.from_numpy(toks), S + 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    _close_planes("native", {n: tc[n] for n in tmodel.plane_names}, jc)
