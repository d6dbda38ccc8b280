"""The port's config registry and its model steps on every new config,
against the JAX package's.

* each registered config is the JAX package's field for field (the port
  carries every field since training brought back the schedule hint;
  ``deepseek-v2-236b-noexperts`` is JAX's DeepSeek-V2 without its
  experts), and so is its ``-smoke`` sibling, with the same
  ``param_count()``; the fields the port adds (routing, held experts,
  drop-free, YaRN) hold their defaults there, and
  ``deepseek-v2-236b-published`` is the mirror with DeepSeek-V2's own;
* ``LM.prefill``, ``decode_step``, ``decode_step_paged``,
  ``step_paged_ragged`` and ``step_ragged`` on ``deepseek-v2-236b-smoke``
  and ``arctic-480b-smoke`` (MoE), ``gemma-7b-smoke`` (GeGLU, tied
  embeddings, embedding scale), ``minicpm-2b-smoke`` (tied embeddings,
  embedding, residual and logit scales) and ``starcoder2-15b-smoke``
  (ungated GELU FFN) match the JAX ``LM``'s on JAX's ``LM.init`` weights
  (``params_from_jax``), logits within 1e-4, fp32.

Serving them is held to JAX in ``test_torch_config_serving.py``,
``test_torch_moe_serving.py`` and ``test_torch_moe_nodrop.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro_torch.configs import REGISTRY, get_config

from torch_serving_pairs import arch_models
from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)

LOGIT_ATOL = 1e-4
NEW_ARCHS = ("deepseek-v2-236b", "arctic-480b", "gemma-7b", "minicpm-2b",
             "starcoder2-15b")
SMOKE = tuple(a + "-smoke" for a in NEW_ARCHS)


# ------------------------------------------------------------------ configs
def _port_fields(cfg, jcfg, f):
    """A field of the port's own (absent from the JAX package's config)
    must hold its default: it changes nothing of the JAX behaviour."""
    if not hasattr(jcfg, f.name):
        assert getattr(cfg, f.name) == f.default, f.name
        return True
    return False


def _same_group(mine, ref, what):
    """One nested config group field for field: the JAX package's fields
    equal, the port's own at their defaults."""
    ref_d = dataclasses.asdict(ref)
    for g in dataclasses.fields(mine):
        if g.name in ref_d:
            assert getattr(mine, g.name) == ref_d[g.name], (what, g.name)
        else:
            assert getattr(mine, g.name) == g.default, (what, g.name)


@pytest.mark.parametrize("name", sorted(n for n in REGISTRY
                                        if "published" not in n))
def test_config_is_jax_config(name):
    cfg = get_config(name)
    if "noexperts" in name:
        jcfg = dataclasses.replace(
            jax_get_config(name.replace("-noexperts", "")),
            name=name, family="attn_dense", moe=None)
    else:
        jcfg = jax_get_config(name)
    for f in dataclasses.fields(cfg):
        if _port_fields(cfg, jcfg, f):
            continue
        mine, ref = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name in ("moe", "mla", "ssm", "hybrid", "frontend") \
                and mine is not None:
            _same_group(mine, ref, f.name)
        else:
            assert mine == ref, f.name
    # the port leaves out no field: the training schedule hint came back
    # with its reader, launch/train.py
    left = {f.name for f in dataclasses.fields(jcfg)} - {
        f.name for f in dataclasses.fields(cfg)}
    assert left == set()
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("suffix", ["", "-smoke"])
def test_published_deepseek_is_the_mirror_with_its_routing_and_yarn(suffix):
    """``deepseek-v2-236b-published`` is the JAX mirror with the routing,
    drop-free mode and YaRN of DeepSeek-V2's ``config.json``; its smoke
    sibling keeps those at small widths (16 experts in 4 groups, a q
    LoRA)."""
    cfg = get_config("deepseek-v2-236b-published" + suffix)
    m, y = cfg.moe, cfg.rope_scaling
    assert (m.topk_method, m.n_group, m.topk_group, m.norm_topk_prob,
            m.routed_scaling_factor, m.drop_free, m.num_held) == \
        ("group_limited_greedy", 8 if not suffix else 4,
         3 if not suffix else 2, False, 16.0, True, 0)
    assert (y.factor, y.original_max_position_embeddings, y.beta_fast,
            y.beta_slow, y.mscale, y.mscale_all_dim) == \
        (40.0, 4096, 32.0, 1.0, 0.707, 0.707)
    if suffix:
        assert (m.num_experts, m.top_k, cfg.mla.q_lora_rank) == (16, 3, 48)
        return
    mirror = get_config("deepseek-v2-236b")
    for f in dataclasses.fields(cfg):
        if f.name not in ("name", "moe", "rope_scaling"):
            assert getattr(cfg, f.name) == getattr(mirror, f.name), f.name
    for f in dataclasses.fields(m):
        if f.name not in ("topk_method", "n_group", "topk_group",
                          "norm_topk_prob", "routed_scaling_factor",
                          "drop_free"):
            assert getattr(m, f.name) == getattr(mirror.moe, f.name), f.name
    assert cfg.param_count() == mirror.param_count()


# ---------------------------------------------------------------- model steps
def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _planes(tmodel, rng, lead):
    """Random fp32 cache planes of the model's descriptor, ``lead +
    plane shape`` each."""
    desc = tmodel.cache_descriptor(4)
    return {p.name: rng.standard_normal(
        (desc.num_layers,) + lead + p.shape).astype(np.float32)
        for p in desc.paged_planes}


@pytest.mark.parametrize("arch", SMOKE)
def test_prefill_and_decode_match_jax(arch):
    jmodel, jparams, tmodel = arch_models(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, (2, 11)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 16)
    tl, tc = tmodel.prefill(_t(toks), 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    assert sorted(tc) == sorted(jc)
    for n in tc:
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=1e-5, err_msg=n)
    nxt = rng.integers(0, 512, (2, 1)).astype(np.int32)
    pos = np.array([11, 11], np.int32)
    jl2, jc2 = jmodel.decode_step(jparams, jc, jnp.asarray(nxt),
                                  jnp.asarray(pos))
    tl2, tc2 = tmodel.decode_step(tc, _t(nxt), _t(pos))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=LOGIT_ATOL)
    for n in tc2:
        np.testing.assert_allclose(tc2[n].numpy(), np.asarray(jc2[n]),
                                   atol=1e-5, err_msg=n)


@pytest.mark.parametrize("arch", SMOKE)
def test_paged_steps_match_jax(arch):
    """``decode_step_paged`` and a ragged ``step_paged_ragged`` with a
    padding row (q_len 0), a decode row and a 5-token chunk row crossing
    a page, over random pools."""
    jmodel, jparams, tmodel = arch_models(arch)
    rng = np.random.default_rng(2)
    pools = _planes(tmodel, rng, (12, 4))
    tbl = np.array([[0, 0, 0, 0], [3, 7, 1, 0], [5, 2, 9, 11]], np.int32)

    def caches(**extra):
        jc = {k: jnp.asarray(v) for k, v in extra.items()}
        tc = {k: _t(v) for k, v in extra.items()}
        for n, a in pools.items():
            jc["pool_" + n], tc["pool_" + n] = jnp.asarray(a), _t(a)
        return jc, tc

    pos = np.array([6, 13], np.int32)
    toks = rng.integers(0, 512, (2, 1)).astype(np.int32)
    jc, tc = caches(pos=pos, block_table=tbl[1:])
    jl, jout = jmodel.decode_step_paged(jparams, jc, jnp.asarray(toks),
                                        jnp.asarray(pos))
    tl, tout = tmodel.decode_step_paged(tc, _t(toks), _t(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    for n in pools:
        np.testing.assert_allclose(tout["pool_" + n].numpy(),
                                   np.asarray(jout["pool_" + n]), atol=1e-5)

    ctx = np.array([0, 6, 7], np.int32)
    qls = np.array([0, 1, 5], np.int32)
    toks = rng.integers(0, 512, (3, 8)).astype(np.int32)
    jc, tc = caches(block_table=tbl)
    jl, jout = jmodel.step_paged_ragged(jparams, jc, jnp.asarray(toks),
                                        jnp.asarray(ctx), jnp.asarray(qls))
    tl, tout = tmodel.step_paged_ragged(tc, _t(toks), _t(ctx), _t(qls))
    for b, q in enumerate(qls):
        np.testing.assert_allclose(tl[b, :q].numpy(), np.asarray(jl[b, :q]),
                                   atol=LOGIT_ATOL)
    for n in pools:
        np.testing.assert_allclose(tout["pool_" + n].numpy(),
                                   np.asarray(jout["pool_" + n]), atol=1e-5)
    assert tout["pos"].tolist() == [0, 7, 12]


@pytest.mark.parametrize("arch", SMOKE)
def test_step_ragged_matches_jax(arch):
    """The dense mirror's fused step over random dense planes, the same
    mixed rows as the pooled step; at q_len 1 everywhere it is the port's
    ``decode_step`` bit for bit."""
    jmodel, jparams, tmodel = arch_models(arch)
    rng = np.random.default_rng(3)
    planes = _planes(tmodel, rng, (3, 24))
    ctx = np.array([0, 6, 11], np.int32)
    qls = np.array([0, 1, 5], np.int32)
    toks = rng.integers(0, 512, (3, 8)).astype(np.int32)
    jc = {"pos": jnp.asarray(ctx), **{n: jnp.asarray(a)
                                      for n, a in planes.items()}}
    tc = {"pos": _t(ctx), **{n: _t(a) for n, a in planes.items()}}
    jl, jout = jmodel.step_ragged(jparams, jc, jnp.asarray(toks),
                                  jnp.asarray(ctx), jnp.asarray(qls))
    tl, tout = tmodel.step_ragged(tc, _t(toks), _t(ctx), _t(qls))
    for b, q in enumerate(qls):
        np.testing.assert_allclose(tl[b, :q].numpy(), np.asarray(jl[b, :q]),
                                   atol=LOGIT_ATOL)
    for n in planes:
        np.testing.assert_allclose(tout[n].numpy(), np.asarray(jout[n]),
                                   atol=1e-5)
    pos = np.array([3, 9, 15], np.int32)
    one = rng.integers(0, 512, (3, 1)).astype(np.int32)
    a = {"pos": _t(pos), **{n: _t(x) for n, x in planes.items()}}
    b = {"pos": _t(pos), **{n: _t(x) for n, x in planes.items()}}
    la, oa = tmodel.step_ragged(a, _t(one), _t(pos),
                                torch.ones(3, dtype=torch.int32))
    lb, ob = tmodel.decode_step(b, _t(one), _t(pos))
    assert torch.equal(la, lb)
    assert all(torch.equal(oa[n], ob[n]) for n in list(planes) + ["pos"])
