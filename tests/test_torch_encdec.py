"""The encoder-decoder family (Seamless-M4T v2) on the port against the JAX
package, on the CPU, with the JAX ``init`` weights carried across.

* ``attn_cross``, the encoder block, the enc-dec decoder block and its
  decode step against the JAX functions, below and past ``chunk_size``
  (the flash kernel's plain version, non-causal for the encoder and the
  cross-attention, causal for the decoder's self-attention);
* ``LM.prefill`` + ``decode_step`` of ``seamless-m4t-large-v2-smoke``
  against the JAX ``LM`` at ``chunk_size=32``, with the frontend inputs of
  ``tests/test_models_smoke.py`` (32 frames of width ``d_model``), and a
  replay of its ``test_decode_matches_full_forward``.

Tolerances (fp32): outputs and logits atol 1e-4, rtol 2e-5, as
``tests/test_torch_long_prefill.py``; cache planes atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import blocks as jax_blocks
from repro.models import build_model
from repro.models.attention import attn_cross as jax_attn_cross
from repro.models.attention import init_attn as jax_init_attn
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention
from repro_torch.models import LM, blocks, params_from_jax
from repro_torch.models.attention import attn_cross

from test_models_smoke import _batch_for
from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)

ARCH = "seamless-m4t-large-v2-smoke"
CHUNK = 32
ATOL, RTOL = 1e-4, 2e-5


class _P:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


def _port_block(np_block, kind):
    """A port block holding layer 0 of ``np_block`` (a JAX block pytree
    with a leading layer axis of 1)."""
    cfg = get_config(ARCH)
    blk = blocks.DecoderBlock(cfg, torch.float32, "cpu", kind)
    blk.load_state_dict({n: _t(a) for n, a in blocks.jax_block_arrays(
        np_block, 0, cfg, kind).items()})
    return blk


def _stacked(tree):
    return jax.tree.map(lambda a: np.asarray(a)[None], tree)


# (S, T, chunk_size): both below chunk_size (full_attention); both past
# it; one query row over encoder frames past it (a decode step's shape);
# decoder past it over a short encoder
CROSS_CASES = [(5, 12, 512), (40, 48, CHUNK), (1, 48, CHUNK),
               (40, 20, CHUNK)]


@pytest.mark.parametrize("case", CROSS_CASES)
def test_attn_cross_matches_jax(case):
    """Cross-attention (no RoPE, no mask) against the JAX ``attn_cross``:
    ``full_attention`` while ``max(S, T) <= chunk_size``, the flash
    kernel's plain version non-causal past it."""
    S, T, chunk = case
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    K, D = cfg.num_kv_heads, cfg.head_dim
    w = _np(jax_init_attn(jax.random.PRNGKey(S + T), jcfg, jnp.float32))
    rng = np.random.default_rng(S + T)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    ek, ev = (rng.standard_normal((2, T, K, D)).astype(np.float32)
              for _ in range(2))
    want = jax_attn_cross(w, jcfg, jnp.asarray(x), jnp.asarray(ek),
                          jnp.asarray(ev), chunk_size=chunk)
    got = attn_cross(_P(**{n: _t(a) for n, a in w.items()}), cfg, _t(x),
                     _t(ek), _t(ev), chunk_size=chunk)
    _close(got, want)


@pytest.mark.parametrize("S", [24, 48])
def test_encoder_block_matches_jax(S):
    """The bidirectional encoder block below and past ``chunk_size``."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    jw = jax_blocks.init_encoder_block(jax.random.PRNGKey(S), jcfg,
                                       jnp.float32)
    blk = _port_block(_stacked(jw), "dense")
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    want = jax_blocks.apply_encoder_block(jw, jcfg, jnp.asarray(x),
                                          jnp.asarray(pos), chunk_size=CHUNK)
    got = blocks.apply_encoder_block(blk, cfg, _t(x), _t(pos),
                                     chunk_size=CHUNK)
    _close(got, want)


@pytest.mark.parametrize("S, T", [(24, 16), (40, 48)])
def test_encdec_decoder_block_matches_jax(S, T):
    """The enc-dec decoder block (causal self-attention, cross-attention
    over ``cross_kv`` of an encoder output, FFN) and its K/V."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    jw = jax_blocks.init_encdec_decoder_block(jax.random.PRNGKey(S), jcfg,
                                              jnp.float32)
    blk = _port_block(_stacked(jw), "encdec")
    rng = np.random.default_rng(S + T)
    h = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    jek, jev = jax_blocks.cross_kv(jw, jcfg, jnp.asarray(enc))
    ek, ev = blocks.cross_kv(blk, cfg, _t(enc))
    _close(ek, jek, atol=1e-5)
    _close(ev, jev, atol=1e-5)
    want, (jk, jv) = jax_blocks.apply_encdec_decoder_block(
        jw, jcfg, jnp.asarray(h), jnp.asarray(pos), jek, jev,
        chunk_size=CHUNK)
    got, (k, v) = blocks.apply_encdec_decoder_block(
        blk, cfg, _t(h), _t(pos), ek, ev, chunk_size=CHUNK)
    _close(got, want)
    _close(k, jk, atol=1e-5)
    _close(v, jv, atol=1e-5)


@pytest.mark.parametrize("T", [48, 600])
def test_decode_encdec_decoder_block_matches_jax(T):
    """One decode step of the enc-dec decoder block: the self-attention
    cache written in place, cross-attention at the default ``chunk_size``
    (512) — past it at 600 encoder frames, through the flash kernel's
    plain version."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    K, D = cfg.num_kv_heads, cfg.head_dim
    jw = jax_blocks.init_encdec_decoder_block(jax.random.PRNGKey(T), jcfg,
                                              jnp.float32)
    blk = _port_block(_stacked(jw), "encdec")
    rng = np.random.default_rng(T)
    h = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, 16, K, D)).astype(np.float32)
              for _ in range(2))
    ek, ev = (rng.standard_normal((2, T, K, D)).astype(np.float32)
              for _ in range(2))
    pos = np.array([3, 9], dtype=np.int32)
    want, (jk, jv) = jax_blocks.decode_encdec_decoder_block(
        jw, jcfg, jnp.asarray(h),
        tuple(jnp.asarray(a) for a in (ck, cv, ek, ev)), jnp.asarray(pos))
    tk, tv = _t(ck), _t(cv)
    got, (k, v) = blocks.decode_encdec_decoder_block(
        blk, cfg, _t(h), (tk, tv, _t(ek), _t(ev)), _t(pos).long())
    _close(got, want)
    assert k is tk and v is tv                      # written in place
    _close(k, jk, atol=1e-5)
    _close(v, jv, atol=1e-5)


_MODELS: dict = {}


def frontend_models(arch, chunk_size=CHUNK, seed=1, kd="native"):
    """(JAX model, JAX params, port model) of a frontend config at
    ``chunk_size``, the JAX weights carried across."""
    key = (arch, chunk_size, seed, kd)
    if key not in _MODELS:
        jmodel = build_model(jax_get_config(arch), remat=False,
                             chunk_size=chunk_size, kv_cache_dtype=kd)
        jparams = jmodel.init(jax.random.PRNGKey(seed))
        cfg = get_config(arch)
        tmodel = LM(cfg, device="cpu", chunk_size=chunk_size,
                    kv_cache_dtype=kd)
        tmodel.load_state_dict(params_from_jax(_np(jparams), cfg))
        _MODELS[key] = (jmodel, jparams, tmodel)
    return _MODELS[key]


def prefill_and_decode(arch, *, B, S, max_len, steps, kd="native"):
    """Prefill ``_batch_for``'s batch (tokens and frontend embeddings of
    ``tests/test_models_smoke.py``) on both packages, then ``steps``
    greedy decode steps of the JAX tokens; asserts logits and every cache
    plane agree at each step."""
    jmodel, jparams, tmodel = frontend_models(arch, kd=kd)
    batch = _batch_for(jax_get_config(arch), B, S)
    before = flash_attention.launches
    jl, jc = jmodel.prefill(jparams, batch, max_len)
    tl, tc = tmodel.prefill(_t(batch["tokens"]), max_len,
                            frontend_embeds=_t(batch["frontend_embeds"]))
    assert set(tc) == set(jc)
    for step in range(steps + 1):
        _close(tl, jl)
        for name in jc:
            if name == "pos":
                assert np.array_equal(tc[name].numpy(), np.asarray(jc[name]))
            elif tc[name].dtype == torch.int8:
                assert np.abs(tc[name].numpy().astype(int) - np.asarray(
                    jc[name]).astype(int)).max() <= 1, name
            else:
                # int8 scales are bf16: one ulp (2^-7 relative) where a
                # max lands on a rounding boundary
                np.testing.assert_allclose(
                    tc[name].float().numpy(), np.asarray(jc[name], np.float32),
                    atol=1e-5, rtol=2 ** -7 if "scale" in name else 0,
                    err_msg=name)
        if step == steps:
            break
        nxt = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(nxt), jc["pos"])
        tl, tc = tmodel.decode_step(tc, _t(nxt), tc["pos"])
    assert flash_attention.launches == before      # the CPU runs no kernel
    return tc


def test_prefill_and_decode_match_jax():
    """``LM.prefill`` (encoder over 32 frames and a 40-token decoder
    prompt, both past ``chunk_size=32``) and 8 greedy ``decode_step``s:
    logits, ``k``/``v`` and the cross K/V ``ek``/``ev`` as JAX's."""
    tc = prefill_and_decode(ARCH, B=2, S=40, max_len=64, steps=8)
    assert tc["ek"].shape == (2, 2, 32, 4, 32)


def test_decode_matches_full_forward():
    """``tests/test_models_smoke.py::test_decode_matches_full_forward`` on
    the port: prefill 64 tokens, decode 8 more, and the last logits match
    a 72-token prefill (relative error below 2e-3); weights from JAX's
    ``init(PRNGKey(1))``, ``chunk_size=32``."""
    _, _, model = frontend_models(ARCH)
    B, S_total, S_pre = 2, 72, 64
    batch = _batch_for(jax_get_config(ARCH), B, S_total)
    toks, fe = _t(batch["tokens"]), _t(batch["frontend_embeds"])
    lg_full, _ = model.prefill(toks, 128, frontend_embeds=fe)
    lg, cache = model.prefill(toks[:, :S_pre], 128, frontend_embeds=fe)
    for t in range(S_pre, S_total):
        lg, cache = model.decode_step(cache, toks[:, t:t + 1], cache["pos"])
    ref, got = lg_full[:, 0].numpy(), lg[:, 0].numpy()
    rel = np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-9)
    assert rel < 2e-3, rel
