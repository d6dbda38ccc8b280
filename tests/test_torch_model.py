"""The port's layers and LM steps against the JAX package's, same weights.

Per-function parity for the primitive layers, then ``internlm2-1.8b-smoke``
with the JAX ``LM.init`` weights carried across by ``params_from_jax``:
prefill, dense decode, paged decode and the ragged paged step with mixed
``q_lens`` (0, 1, chunk). Logits agree within 1e-4 and the updated pool
contents within 1e-5 (fp32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model
from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.models import LM, params_from_jax
from repro_torch.models import layers as tl

ARCH = "internlm2-1.8b-smoke"
LOGIT_ATOL = 1e-4
POOL_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


class _P:
    """Attribute access over a dict of torch tensors (port layer params)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_layer_functions_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        tl.rmsnorm(_t(scale), _t(x), 1e-5).numpy(),
        np.asarray(jl.rmsnorm({"scale": scale}, x, 1e-5)), atol=1e-6)

    xr = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tl.apply_rope(_t(xr), _t(pos), 1e6).numpy(),
        np.asarray(jl.apply_rope(xr, pos, 1e6)), atol=2e-5)

    w = {k: (rng.standard_normal(s) / 8).astype(np.float32)
         for k, s in (("w_gate", (64, 96)), ("w_up", (64, 96)),
                      ("w_down", (96, 64)))}
    np.testing.assert_allclose(
        tl.apply_ffn(_P(**{k: _t(v) for k, v in w.items()}), _t(x),
                     "swiglu").numpy(),
        np.asarray(jl.apply_ffn(w, x, "swiglu")), atol=1e-5)

    table = rng.standard_normal((128, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tl.lm_logits(_t(table), _t(x), vocab_size=100).numpy(),
        np.asarray(jl.lm_logits({"table": table}, None, x, True,
                                vocab_size=100)), atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config(ARCH)
    jmodel = build_model(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH)
    tmodel = LM(cfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, tmodel


def _close(a_t, b_j, atol):
    np.testing.assert_allclose(a_t.float().numpy(),
                               np.asarray(b_j, np.float32), atol=atol)


def test_prefill_and_dense_decode_match_jax(models):
    jmodel, jparams, tmodel = models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, (2, 11)).astype(np.int32)
    jl_, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 16)
    tl_, tc = tmodel.prefill(_t(toks), 16)
    _close(tl_, jl_, LOGIT_ATOL)
    for n in ("k", "v"):
        _close(tc[n], jc[n], POOL_ATOL)
    nxt = rng.integers(0, 512, (2, 1)).astype(np.int32)
    pos = np.array([11, 11], np.int32)
    jl2, jc2 = jmodel.decode_step(jparams, jc, jnp.asarray(nxt),
                                  jnp.asarray(pos))
    tl2, tc2 = tmodel.decode_step(tc, _t(nxt), _t(pos))
    _close(tl2, jl2, LOGIT_ATOL)
    _close(tc2["k"], jc2["k"], POOL_ATOL)
    assert tc2["pos"].tolist() == [12, 12]


def _pool_inputs(cfg, rng, P=12, T=4):
    shape = (cfg.num_layers, P, T, cfg.num_kv_heads, cfg.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def test_paged_decode_matches_jax(models):
    jmodel, jparams, tmodel = models
    rng = np.random.default_rng(2)
    pk, pv = _pool_inputs(tmodel.cfg, rng)
    tbl = np.array([[3, 7, 1, 0], [5, 2, 9, 11]], np.int32)
    pos = np.array([6, 13], np.int32)
    toks = rng.integers(0, 512, (2, 1)).astype(np.int32)
    jc = {"pos": jnp.asarray(pos), "block_table": jnp.asarray(tbl),
          "pool_k": jnp.asarray(pk), "pool_v": jnp.asarray(pv)}
    tc = {"pos": _t(pos), "block_table": _t(tbl), "pool_k": _t(pk),
          "pool_v": _t(pv)}
    jlog, jout = jmodel.decode_step_paged(jparams, jc, jnp.asarray(toks),
                                          jnp.asarray(pos))
    tlog, tout = tmodel.decode_step_paged(tc, _t(toks), _t(pos))
    _close(tlog, jlog, LOGIT_ATOL)
    for n in ("pool_k", "pool_v"):
        assert tout[n] is tc[n]              # scattered in place
        _close(tout[n], jout[n], POOL_ATOL)


def test_ragged_paged_step_matches_jax(models):
    """Mixed rows in one fused step: a padding row (q_len 0), a decode row
    (q_len 1) and a prefill-chunk row (q_len 5, crossing a page)."""
    jmodel, jparams, tmodel = models
    rng = np.random.default_rng(3)
    pk, pv = _pool_inputs(tmodel.cfg, rng)
    tbl = np.array([[0, 0, 0, 0], [3, 7, 1, 0], [5, 2, 9, 11]], np.int32)
    ctx = np.array([0, 6, 7], np.int32)
    qls = np.array([0, 1, 5], np.int32)
    toks = rng.integers(0, 512, (3, 8)).astype(np.int32)
    jc = {"block_table": jnp.asarray(tbl), "pool_k": jnp.asarray(pk),
          "pool_v": jnp.asarray(pv)}
    tc = {"block_table": _t(tbl), "pool_k": _t(pk), "pool_v": _t(pv)}
    jlog, jout = jmodel.step_paged_ragged(jparams, jc, jnp.asarray(toks),
                                          jnp.asarray(ctx), jnp.asarray(qls))
    tlog, tout = tmodel.step_paged_ragged(tc, _t(toks), _t(ctx), _t(qls))
    for b, q in enumerate(qls):
        _close(tlog[b, :q], jlog[b, :q], LOGIT_ATOL)
    for n in ("pool_k", "pool_v"):
        _close(tout[n], jout[n], POOL_ATOL)
    # the padding row touched nothing: page 0 is only row 0's (dead) page
    np.testing.assert_array_equal(tout["pool_k"][:, 0].numpy(), pk[:, 0])
    assert tout["pos"].tolist() == [0, 7, 12]
