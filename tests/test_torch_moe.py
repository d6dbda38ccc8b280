"""The port's mixture-of-experts FFN against the JAX package's.

* ``_route``: the same expert ids, bit for bit, on seeded inputs with tied
  router probabilities; the weights and the load-balancing loss within
  fp32 rounding (the two packages' fp32 products and softmax sum in
  different orders);
* ``moe_dispatch_combine`` with drops forced (capacity below the load, a
  block of identical padding tokens that all pick the same experts),
  fp32, atol 1e-5, and at no-drop capacity;
* ``apply_moe`` with DeepSeek-V2's shared experts and with Arctic's
  parallel dense residual, on each smoke config's JAX weights;
* ``kv_cache_dtype="int8"`` on a MoE config keeps the native ``(k, v)``
  cache, as in JAX.

Serving the MoE configs is held to JAX in ``test_torch_moe_serving.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model
from repro.models import moe as jax_moe
from repro_torch.configs import get_config
from repro_torch.models import LM, params_from_jax
from repro_torch.models import moe

from torch_serving_pairs import arch_models
from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)

MOE_ARCHS = ("deepseek-v2-236b-smoke", "arctic-480b-smoke")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _router_inputs(rng, T=24, d=16, E=8):
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = rng.standard_normal((d, E)).astype(np.float32)
    x[5:9] = 0.0           # a zero row: uniform probabilities, all tied
    return x, w


def test_route_matches_jax():
    rng = np.random.default_rng(0)
    x, w = _router_inputs(rng)
    for k in (1, 2, 6):
        ids, wts, aux = moe._route(_t(w), _t(x), 8, k)
        jids, jwts, jaux = jax_moe._route(jnp.asarray(w), jnp.asarray(x), 8,
                                          k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(wts.numpy(), np.asarray(jwts),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
        # the tied rows pick the lowest expert ids, as lax.top_k does
        assert ids[5].tolist() == list(range(k))


def _experts(rng, E, d, f):
    return {n: (rng.standard_normal(shape) / np.sqrt(shape[1])).astype(
        np.float32) for n, shape in (("w_gate", (E, d, f)),
                                     ("w_up", (E, d, f)),
                                     ("w_down", (E, f, d)))}


class _NS:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("capacity", [3, 48])
def test_dispatch_combine_matches_jax(capacity, act):
    """Capacity 3 drops most of the load — the 8 identical padding tokens
    all pick the same two experts, and the real tokens compete with them
    for slots — while 48 (T * k) drops nothing."""
    rng = np.random.default_rng(1)
    T, d, f, E, k = 24, 16, 32, 8, 2
    x, w = _router_inputs(rng, T, d, E)
    x[16:] = x[16]                         # padding: one token, 8 times
    ex = _experts(rng, E, d, f)
    ids, wts, _ = moe._route(_t(w), _t(x), E, k)
    counts = np.bincount(ids.numpy().ravel(), minlength=E)
    assert (counts.max() > capacity) == (capacity == 3)
    got = moe.moe_dispatch_combine(_NS(**{n: _t(a) for n, a in ex.items()}),
                                   _t(x), ids, wts, E, capacity, act)
    want = jax_moe.moe_dispatch_combine(
        {n: jnp.asarray(a) for n, a in ex.items()}, jnp.asarray(x),
        jnp.asarray(ids.numpy()), jnp.asarray(wts.numpy()), E, capacity, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if capacity == 3:                # some token lost every expert: y = 0
        assert (got.abs().sum(-1) == 0).any()


def _jax_block_ffn(jparams, i):
    return jax.tree.map(lambda a: a[i], jparams["moe_blocks"]["ffn"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_matches_jax(arch):
    """One MoE block's FFN on its smoke config's JAX weights: shared
    experts (DeepSeek-V2) or the parallel dense residual (Arctic), at the
    published capacity factor on a (B, S) block that drops tokens."""
    jmodel, jparams, tmodel = arch_models(arch)
    cfg = tmodel.cfg
    blk = next(b for b in tmodel.blocks if b.ffn_kind == "moe")
    assert (getattr(blk, "shared", None) is not None) == (
        cfg.moe.num_shared_experts > 0)
    assert (getattr(blk, "dense", None) is not None) == cfg.moe.dense_residual
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 16, cfg.d_model)).astype(np.float32)
    x[2] = x[2, 0]                     # a row of one repeated token
    y, aux = moe.apply_moe(blk, cfg, _t(x))
    jy, jaux = jax_moe.apply_moe(_jax_block_ffn(jparams, 0),
                                 jax_get_config(arch), jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    ids, _, _ = moe._route(blk.router, _t(x).reshape(48, -1),
                           cfg.moe.num_experts, cfg.moe.top_k)
    capacity = max(int(cfg.moe.capacity_factor * 48 * cfg.moe.top_k
                       / cfg.moe.num_experts), 4)
    assert np.bincount(ids.numpy().ravel()).max() > capacity   # drops


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_int8_request_keeps_native_cache_on_moe(arch):
    """As in JAX, ``kv_cache_dtype="int8"`` does not quantize a MoE
    config's cache: the same planes, the same prefill cache and logits."""
    jcfg = jax_get_config(arch)
    jmodel = build_model(jcfg, remat=False, kv_cache_dtype="int8")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch)
    tmodel = LM(cfg, device="cpu", kv_cache_dtype="int8")
    tmodel.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg))
    assert tmodel.cache_family == jmodel.cache_descriptor().family
    assert tmodel.cache_family in ("dense", "mla")
    toks = np.random.default_rng(3).integers(0, 512, (2, 9)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 12)
    tl, tc = tmodel.prefill(_t(toks), 12)
    assert sorted(tc) == sorted(jc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for n in tc:
        if n != "pos":
            assert tc[n].dtype == torch.float32
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       atol=1e-5)
