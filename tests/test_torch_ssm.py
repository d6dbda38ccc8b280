"""The port's Mamba-2 mixer and block against the JAX package's, fp32 on
the CPU, at ``mamba2-1.3b-smoke`` width (d_model 128, 16 heads of 16,
d_state 16, chunk 64).

Inputs come from a seeded numpy generator and weights from the JAX
``init_ssm``/``LM.init``, carried across. Module outputs and states agree
within 1e-5 of the reference's largest magnitude, LM logits within 1e-4.
The ragged step's kept slot states (the engine keeps only the slots a row
can commit) are the full per-slot stack's entries bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import blocks as jax_blocks
from repro.models import build_model
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_config
from repro_torch.models import LM, params_from_jax
from repro_torch.models import blocks as B
from repro_torch.models import ssm

ARCH = "mamba2-1.3b-smoke"
MOD_RTOL = 1e-5
LOGIT_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, rtol=MOD_RTOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.fixture(scope="module")
def block():
    """(JAX SSM block params, port SSMBlock) at smoke width, fp32."""
    cfg = get_config(ARCH)
    jp = jax_blocks.init_ssm_block(jax.random.PRNGKey(3), jax_get_config(ARCH),
                                   jnp.float32)
    npp = jax.tree.map(np.asarray, jp)
    blk = B.SSMBlock(cfg, torch.float32, "cpu")
    blk.load_state_dict({k: _t(v) for k, v in B.ssm_block_arrays(
        {k: jax.tree.map(lambda a: a[None], v) for k, v in npp.items()},
        0).items()})
    return jp, blk


def _rng_states(rng, cfg, b):
    _, d_inner, H, conv_dim = ssm._dims(cfg)
    s = cfg.ssm
    conv = rng.standard_normal((b, s.d_conv - 1, conv_dim)).astype(np.float32)
    st = rng.standard_normal((b, H, s.head_dim, s.d_state)).astype(np.float32)
    return conv, st


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(with_state):
    rng = np.random.default_rng(0)
    b, T, H, P, N, Q = 2, 128, 4, 8, 16, 64
    x = rng.standard_normal((b, T, H, P)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.2, (b, T, H)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (H,)).astype(np.float32)
    Bm = rng.standard_normal((b, T, N)).astype(np.float32)
    Cm = rng.standard_normal((b, T, N)).astype(np.float32)
    s0 = (rng.standard_normal((b, H, P, N)).astype(np.float32)
          if with_state else None)
    jy, js = jax_ssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                                 Q, None if s0 is None else jnp.asarray(s0))
    ty, ts = ssm.ssd_chunked(*(_t(a) for a in (x, dt, A, Bm, Cm)), Q,
                             None if s0 is None else _t(s0))
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("T", [64, 50])
def test_apply_ssm_matches_jax(block, T):
    """T = 64 is one chunk; T = 50 pads to it with dt = 0."""
    jp, blk = block
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    x = np.random.default_rng(T).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)
    jy, (jconv, jst) = jax_ssm.apply_ssm(jp["mixer"], jcfg, jnp.asarray(x))
    with torch.no_grad():
        ty, (tconv, tst) = ssm.apply_ssm(blk, cfg, _t(x))
    _close(ty, jy)
    _close(tconv, jconv)
    _close(tst, jst)


def test_ssm_decode_matches_jax(block):
    jp, blk = block
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    conv, st = _rng_states(rng, cfg, 3)
    jy, (jc, js) = jax_ssm.ssm_decode(jp["mixer"], jcfg, jnp.asarray(x),
                                      jnp.asarray(conv), jnp.asarray(st))
    tconv, tst = _t(conv), _t(st)
    with torch.no_grad():
        ty, (tc, ts) = ssm.ssm_decode(blk, cfg, _t(x), tconv, tst)
    _close(ty, jy)
    _close(tc, jc)
    _close(ts, js)
    # the inputs are left as they are
    assert torch.equal(tconv, _t(conv)) and torch.equal(tst, _t(st))


@pytest.fixture(scope="module")
def ragged_case(block):
    jp, blk = block
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    rng = np.random.default_rng(11)
    q_lens = np.array([3, 0, 1, 4], np.int32)
    h = rng.standard_normal((4, 4, cfg.d_model)).astype(np.float32)
    conv, st = _rng_states(rng, cfg, 4)
    want = jax_blocks.step_ragged_ssm_block(
        jp, jcfg, jnp.asarray(h), jnp.asarray(conv), jnp.asarray(st),
        jnp.asarray(q_lens))
    with torch.no_grad():
        got = B.step_ragged_ssm_block(blk, cfg, _t(h), _t(conv), _t(st),
                                      _t(q_lens))
    return (blk, cfg, h, conv, st, q_lens), want, got


def test_step_ragged_ssm_block_matches_jax(ragged_case):
    _, want, got = ragged_case
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("keep_from,n_keep", [
    ([2, 4, 0, 3], 1),          # the committed slot of every row
    ([0, 4, 0, 1], 3),          # speculative rows: their last 3 slots
    ([1, 0, 0, 2], 2),
])
def test_kept_slots_are_the_full_stack_entries(ragged_case, keep_from,
                                               n_keep):
    (blk, cfg, h, conv, st, q_lens), _, (h_full, c_full, s_full) = \
        ragged_case
    with torch.no_grad():
        h_k, c_k, s_k = B.step_ragged_ssm_block(
            blk, cfg, _t(h), _t(conv), _t(st), _t(q_lens),
            keep=(keep_from, n_keep))
    assert torch.equal(h_k, h_full)
    assert c_k.shape[0] == n_keep and s_k.shape[0] == n_keep
    for b, f in enumerate(keep_from):
        for k in range(n_keep):
            if f + k < h.shape[1]:
                assert torch.equal(c_k[k, b], c_full[f + k, b])
                assert torch.equal(s_k[k, b], s_full[f + k, b])
            else:
                assert not bool(c_k[k, b].any()) and not bool(s_k[k, b].any())


@pytest.fixture(scope="module")
def lm_pair():
    jmodel = build_model(jax_get_config(ARCH), remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH)
    tmodel = LM(cfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                           cfg))
    return jmodel, jparams, tmodel


def test_lm_steps_match_jax(lm_pair):
    """``LM.prefill``, ``decode_step`` and ``step_ragged`` (the full
    per-slot stack) against JAX."""
    jmodel, jparams, tmodel = lm_pair
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, (2, 50)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 64)
    tl, tc = tmodel.prefill(_t(toks), 64)
    _close(tl, jl, LOGIT_RTOL)
    assert set(tc) == set(jc) == {"pos", "conv", "ssm"}
    for k in ("conv", "ssm"):
        _close(tc[k], jc[k])
    nxt = rng.integers(0, 512, (2, 1)).astype(np.int32)
    jl, jc2 = jmodel.decode_step(jparams, jc, jnp.asarray(nxt), jc["pos"])
    tl, tc2 = tmodel.decode_step(tc, _t(nxt), tc["pos"])
    _close(tl, jl, LOGIT_RTOL)
    for k in ("conv", "ssm"):
        _close(tc2[k], jc2[k])
    assert np.array_equal(tc2["pos"].numpy(), np.asarray(jc2["pos"]))
    tk = rng.integers(0, 512, (2, 4)).astype(np.int32)
    ql = np.array([4, 2], np.int32)
    ctx = np.asarray(jc["pos"])
    jl, jc3 = jmodel.step_ragged(jparams, jc, jnp.asarray(tk),
                                 jnp.asarray(ctx), jnp.asarray(ql))
    tl, tc3 = tmodel.step_ragged(tc, _t(tk), _t(ctx), _t(ql))
    _close(tl, jl, LOGIT_RTOL)
    for k in ("conv", "ssm", "conv_steps", "ssm_steps"):
        _close(tc3[k], jc3[k])
    assert np.array_equal(tc3["pos"].numpy(), np.asarray(jc3["pos"]))


def test_padding_is_noop(lm_pair):
    """The port's form of ``test_mamba2_padding_is_noop``: a 50-token
    prefill (padded to the 64-token chunk with dt = 0) then 14 decode
    steps lands where the chunk-aligned 64-token prefill does; the padded
    prefill's states are JAX's."""
    jmodel, jparams, tmodel = lm_pair
    toks = np.random.default_rng(9).integers(0, 512, (1, 64)).astype(np.int32)
    lg1, _ = tmodel.prefill(_t(toks), 128)
    lg, c2 = tmodel.prefill(_t(toks[:, :50]), 128)
    _, jc2 = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :50])},
                            128)
    for k in ("conv", "ssm"):
        _close(c2[k], jc2[k])
    for t in range(50, 64):
        lg, c2 = tmodel.decode_step(c2, _t(toks[:, t:t + 1]), c2["pos"])
    rel = float((lg[:, 0] - lg1[:, 0]).abs().max())
    assert rel / (float(lg1.abs().max()) + 1e-9) < 2e-3
