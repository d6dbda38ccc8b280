"""The port's paged-attention entries against the JAX package's.

The plain PyTorch versions (what a CPU tensor runs) are held against the
JAX Pallas kernels run in interpret mode, on the shape/dtype cases of
``tests/test_kernels.py`` with its tolerances — dense, int8 and MLA pools;
the contract edges and the bitwise pins are checked on the port alone. The
CUDA kernels themselves are held against the plain versions on the card in
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mla_paged_attention as jax_mla_paged_attention
from repro.kernels import mla_paged_attention_ragged as jax_mla_ragged
from repro.kernels import paged_attention as jax_paged_attention
from repro.kernels import paged_attention_q8 as jax_paged_attention_q8
from repro.kernels import paged_attention_ragged as jax_paged_attention_ragged
from repro.kernels import paged_attention_ragged_q8 as jax_ragged_q8
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    mla_paged_attention_ragged_ref, mla_paged_attention_ref,
    paged_attention_q8_ref, paged_attention_ragged_q8_ref,
    paged_attention_ragged_ref, paged_attention_ref)
from test_kernels import _mla_inputs, _q8_inputs
from test_torch_cuda import (_edge_inputs, _mla_edge_inputs, _poison_dead,
                             _poison_dead_mla, _poison_dead_q8,
                             _q8_edge_inputs)

# tests/test_kernels.py: atol 5·_RTOL, rtol 2·_RTOL
_TOL = {"float32": (1e-4, 4e-5), "bfloat16": (1e-1, 4e-2)}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

PAGED_CASES = [
    # (B, H, K, D, page_tokens, pool_pages, max_pages)
    (3, 8, 4, 64, 16, 24, 6),
    (1, 4, 4, 128, 8, 8, 4),
    (2, 16, 2, 64, 32, 10, 4),
    (4, 8, 8, 256, 16, 40, 8),
]
RAGGED_CASES = [
    # (B, Qmax, H, K, D, page_tokens, pool_pages, max_pages)
    (3, 4, 8, 4, 64, 16, 24, 6),
    (1, 8, 4, 4, 128, 8, 8, 4),
    (2, 2, 16, 2, 64, 32, 10, 4),
    (4, 1, 8, 8, 256, 16, 40, 4),
]


def _both(arr, dtype):
    """One numpy array as (jax array, torch tensor) of the same dtype."""
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return jnp.asarray(arr, _JNP[dtype]), t.to(_TORCH[dtype])


def _close(out_t, out_j, dtype):
    atol, rtol = _TOL[dtype]
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_decode_matches_jax_kernel(case, dtype):
    B, H, K, D, T, P, MP = case
    rng = np.random.default_rng(1)
    qj, qt = _both(rng.standard_normal((B, H, D)), dtype)
    kj, kt = _both(rng.standard_normal((P, T, K, D)), dtype)
    vj, vt = _both(rng.standard_normal((P, T, K, D)), dtype)
    tbl = (rng.permutation(P)[:B * MP].reshape(B, MP) if P >= B * MP
           else rng.integers(0, P, (B, MP))).astype(np.int32)
    lens = rng.integers(1, T * MP, B).astype(np.int32)
    out_j = jax_paged_attention(qj, kj, vj, jnp.asarray(tbl),
                                jnp.asarray(lens), force_pallas=True)
    out_t = paged_attention_ref(qt, kt, vt, torch.from_numpy(tbl),
                                torch.from_numpy(lens))
    _close(out_t, out_j, dtype)


def _ragged_inputs(case, dtype, seed=12):
    B, Qm, H, K, D, T, P, MP = case
    rng = np.random.default_rng(seed)
    q = _both(rng.standard_normal((B, Qm, H, D)), dtype)
    pk = _both(rng.standard_normal((P, T, K, D)), dtype)
    pv = _both(rng.standard_normal((P, T, K, D)), dtype)
    tbl = rng.integers(0, P, (B, MP)).astype(np.int32)
    qls = rng.integers(1, Qm + 1, B).astype(np.int32)
    lens = (rng.integers(0, T * MP - Qm, B) + qls).astype(np.int32)
    return q, pk, pv, tbl, lens, qls


@pytest.mark.parametrize("case", RAGGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ragged_matches_jax_kernel(case, dtype):
    (qj, qt), (kj, kt), (vj, vt), tbl, lens, qls = _ragged_inputs(case, dtype)
    out_j = jax_paged_attention_ragged(
        qj, kj, vj, jnp.asarray(tbl), jnp.asarray(lens), jnp.asarray(qls),
        force_pallas=True)
    out_t = paged_attention_ragged_ref(qt, kt, vt, torch.from_numpy(tbl),
                                       torch.from_numpy(lens),
                                       torch.from_numpy(qls))
    _close(out_t, out_j, dtype)


def test_plain_ragged_contract_edges():
    """q_len == 0 rows and padding slots are exactly zero; dead pages and
    stale table tails change nothing; agreement with the JAX oracle."""
    q, pk, pv, tbl, lens, qls = _edge_inputs()
    out = paged_attention_ragged_ref(q, pk, pv, tbl, lens, qls)
    ref = jax_paged_attention_ragged(
        jnp.asarray(q.numpy()), jnp.asarray(pk.numpy()),
        jnp.asarray(pv.numpy()), jnp.asarray(tbl.numpy()),
        jnp.asarray(lens.numpy()), jnp.asarray(qls.numpy()),
        force_pallas=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=2e-5)
    for b in range(q.shape[0]):
        assert torch.all(out[b, int(qls[b]):] == 0.0), b
    pk2, pv2, tbl2 = _poison_dead(pk, pv, tbl, lens, pk.shape[1])
    out2 = paged_attention_ragged_ref(q, pk2, pv2, tbl2, lens, qls)
    np.testing.assert_allclose(out2.numpy(), out.numpy(), atol=1e-5)


def test_plain_ragged_qlen1_is_bitwise_plain_decode():
    q, pk, pv, tbl, _, _ = _edge_inputs(seed=13)
    T = pk.shape[1]
    lens = torch.tensor([1, 7, T, T * tbl.shape[1] - 2], dtype=torch.int32)
    ones = torch.ones(q.shape[0], dtype=torch.int32)
    r1 = paged_attention_ragged_ref(q[:, :1], pk, pv, tbl, lens, ones)
    d1 = paged_attention_ref(q[:, 0], pk, pv, tbl, lens)
    assert torch.equal(r1[:, 0], d1)
    zero = paged_attention_ref(q[:, 0], pk, pv, tbl,
                               torch.tensor([0, 1, 2, 3], dtype=torch.int32))
    assert torch.all(zero[0] == 0.0)


def _t(a):
    """A JAX array as a torch tensor (bf16 goes through fp32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


# the inputs of tests/test_kernels.py (_q8_inputs, _mla_inputs): two layers
# of a ragged batch with a q_len == 0 row, a decode row and two chunk rows;
# the single-layer entries run layer by layer
@pytest.mark.parametrize("layer", [0, 1])
def test_plain_q8_matches_jax_kernel(layer):
    q, pk, pv, ks, vs, tbl, lens, qls = _q8_inputs()
    q, pk, pv, ks, vs = (a[layer] for a in (q, pk, pv, ks, vs))
    out_j = jax_ragged_q8(q, pk, pv, ks, vs, tbl, lens, qls,
                          force_pallas=True)
    args = [_t(a) for a in (q, pk, pv, ks, vs, tbl, lens, qls)]
    out_t = paged_attention_ragged_q8_ref(*args)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=1e-4, rtol=4e-5)
    for b in range(out_t.shape[0]):
        assert torch.all(out_t[b, int(qls[b]):] == 0.0), b
    ones = jnp.ones_like(qls)
    lens1 = jnp.maximum(lens, 1)
    dec_j = jax_paged_attention_q8(q[:, 0], pk, pv, ks, vs, tbl, lens1,
                                   force_pallas=True)
    dec_t = paged_attention_q8_ref(args[0][:, 0], *args[1:6], _t(lens1))
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), atol=1e-4,
                               rtol=4e-5)
    r1 = paged_attention_ragged_q8_ref(args[0][:, :1], *args[1:6],
                                       _t(lens1), _t(ones))
    assert torch.equal(r1[:, 0], dec_t)


@pytest.mark.parametrize("layer", [0, 1])
def test_plain_mla_matches_jax_kernel(layer):
    q_c, q_r, pc, pkr, tbl, lens, qls, scale = _mla_inputs()
    q_c, q_r, pc, pkr = (a[layer] for a in (q_c, q_r, pc, pkr))
    out_j = jax_mla_ragged(q_c, q_r, pc, pkr, tbl, lens, qls, scale=scale,
                           force_pallas=True)
    args = [_t(a) for a in (q_c, q_r, pc, pkr, tbl, lens, qls)]
    out_t = mla_paged_attention_ragged_ref(*args, scale=scale)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=1e-4, rtol=4e-5)
    for b in range(out_t.shape[0]):
        assert torch.all(out_t[b, int(qls[b]):] == 0.0), b
    lens1 = jnp.maximum(lens, 1)
    dec_j = jax_mla_paged_attention(q_c[:, 0], q_r[:, 0], pc, pkr, tbl, lens1,
                                    scale=scale, force_pallas=True)
    dec_t = mla_paged_attention_ref(args[0][:, 0], args[1][:, 0], *args[2:5],
                                    _t(lens1), scale=scale)
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), atol=1e-4,
                               rtol=4e-5)
    r1 = mla_paged_attention_ragged_ref(
        args[0][:, :1], args[1][:, :1], *args[2:5], _t(lens1),
        torch.ones_like(args[6]), scale=scale)
    assert torch.equal(r1[:, 0], dec_t)


# DeepSeek-V2's MLA widths (128 heads share each latent page: the shape the
# CUDA kernel's 64-row tiles are cut for), a few 16-token pages, ragged
# q_lens including 0
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_plain_mla_matches_jax_kernel_at_deepseek_widths(pool_dtype):
    B, Qm, H, dc, dr, T, MP = 3, 3, 128, 512, 64, 16, 3
    P = B * MP + 2
    rng = np.random.default_rng(35)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    (q_c_j, q_c), (q_r_j, q_r) = _both(f(B, Qm, H, dc), "float32"), \
        _both(f(B, Qm, H, dr), "float32")
    (pc_j, pc), (pkr_j, pkr) = _both(f(P, T, dc), pool_dtype), \
        _both(f(P, T, dr), pool_dtype)
    tbl = rng.permutation(P)[:B * MP].reshape(B, MP).astype(np.int32)
    lens = np.array([40, 17, 9], np.int32)
    qls = np.array([3, 0, 2], np.int32)
    scale = float(1.0 / np.sqrt(128 + 64))
    out_j = jax_mla_ragged(q_c_j, q_r_j, pc_j, pkr_j, jnp.asarray(tbl),
                           jnp.asarray(lens), jnp.asarray(qls), scale=scale,
                           force_pallas=True)
    rows = tuple(torch.from_numpy(a) for a in (tbl, lens, qls))
    out_t = mla_paged_attention_ragged_ref(q_c, q_r, pc, pkr, *rows,
                                           scale=scale)
    _close(out_t, out_j, "float32")
    for b in range(B):
        assert torch.all(out_t[b, int(qls[b]):] == 0.0), b
    dec_j = jax_mla_paged_attention(q_c_j[:, 0], q_r_j[:, 0], pc_j, pkr_j,
                                    jnp.asarray(tbl), jnp.asarray(lens),
                                    scale=scale, force_pallas=True)
    dec_t = mla_paged_attention_ref(q_c[:, 0], q_r[:, 0], pc, pkr, rows[0],
                                    rows[1], scale=scale)
    _close(dec_t, dec_j, "float32")


def test_plain_q8_contract_edges():
    """int8 pool: padding slots and q_len == 0 rows exactly zero; dead
    codes at ±127 with scales at 1e6 and stale table tails change nothing;
    the plain version equals the JAX interpret-mode kernel."""
    q, pk, pv, ks, vs, tbl, lens, qls = _q8_edge_inputs()
    out = paged_attention_ragged_q8_ref(q, pk, pv, ks, vs, tbl, lens, qls)
    ref = jax_ragged_q8(*(jnp.asarray(t.numpy()) for t in (q, pk, pv)),
                        jnp.asarray(ks.float().numpy(), jnp.bfloat16),
                        jnp.asarray(vs.float().numpy(), jnp.bfloat16),
                        jnp.asarray(tbl.numpy()), jnp.asarray(lens.numpy()),
                        jnp.asarray(qls.numpy()), force_pallas=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=4e-5)
    for b in range(q.shape[0]):
        assert torch.all(out[b, int(qls[b]):] == 0.0), b
    pk2, pv2, ks2, vs2, tbl2 = _poison_dead_q8(pk, pv, ks, vs, tbl, lens)
    assert torch.equal(
        paged_attention_ragged_q8_ref(q, pk2, pv2, ks2, vs2, tbl2, lens, qls),
        out)


def test_plain_mla_contract_edges():
    """MLA pool: padding and q_len == 0 rows zero; dead latent pages and
    stale tails change nothing; equal to the JAX interpret-mode kernel."""
    q_c, q_r, pc, pkr, tbl, lens, qls, scale = _mla_edge_inputs()
    out = mla_paged_attention_ragged_ref(q_c, q_r, pc, pkr, tbl, lens, qls,
                                         scale=scale)
    ref = jax_mla_ragged(*(jnp.asarray(t.numpy()) for t in
                           (q_c, q_r, pc, pkr, tbl, lens, qls)),
                         scale=scale, force_pallas=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=4e-5)
    for b in range(q_c.shape[0]):
        assert torch.all(out[b, int(qls[b]):] == 0.0), b
    pc2, pkr2, tbl2 = _poison_dead_mla(pc, pkr, tbl, lens)
    assert torch.equal(mla_paged_attention_ragged_ref(
        q_c, q_r, pc2, pkr2, tbl2, lens, qls, scale=scale), out)


def test_cpu_tensor_takes_plain_version_without_launching():
    q, pk, pv, tbl, lens, qls = _edge_inputs()
    before = [e.launches for e in ops.ENTRIES]
    out = ops.paged_attention_ragged(q, pk, pv, tbl, lens, qls)
    assert torch.equal(out, paged_attention_ragged_ref(q, pk, pv, tbl, lens,
                                                       qls))
    dec = ops.paged_attention(q[:, 0], pk, pv, tbl, lens)
    assert torch.equal(dec, paged_attention_ref(q[:, 0], pk, pv, tbl, lens))
    q, pk, pv, ks, vs, tbl, lens, qls = _q8_edge_inputs()
    assert torch.equal(
        ops.paged_attention_ragged_q8(q, pk, pv, ks, vs, tbl, lens, qls),
        paged_attention_ragged_q8_ref(q, pk, pv, ks, vs, tbl, lens, qls))
    assert torch.equal(
        ops.paged_attention_q8(q[:, 0], pk, pv, ks, vs, tbl, lens),
        paged_attention_q8_ref(q[:, 0], pk, pv, ks, vs, tbl, lens))
    q_c, q_r, pc, pkr, tbl, lens, qls, scale = _mla_edge_inputs()
    assert torch.equal(
        ops.mla_paged_attention_ragged(q_c, q_r, pc, pkr, tbl, lens, qls,
                                       scale=scale),
        mla_paged_attention_ragged_ref(q_c, q_r, pc, pkr, tbl, lens, qls,
                                       scale=scale))
    assert torch.equal(
        ops.mla_paged_attention(q_c[:, 0], q_r[:, 0], pc, pkr, tbl, lens,
                                scale=scale),
        mla_paged_attention_ref(q_c[:, 0], q_r[:, 0], pc, pkr, tbl, lens,
                                scale=scale))
    assert [e.launches for e in ops.ENTRIES] == before
