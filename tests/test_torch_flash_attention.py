"""The port's ``flash_attention`` against the JAX package's, on the CPU.

Same seeded numpy inputs through the JAX Pallas kernel in interpret mode
(``force_pallas=True``, as ``tests/test_kernels.py`` runs it) and through
the port's entry, which takes CPU tensors to its plain version — the
function the CUDA kernel is held to on the card. Tolerances are
``tests/test_kernels.py``'s for the kernel against its oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro.models.attention import chunked_attention as jax_chunked_attention
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

from test_kernels import FLASH_CASES, _RTOL

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, Sq, Skv, H, K, D, dtype, seed=0):
    """(jax q, k, v), (torch q, k, v) holding the same values."""
    jd, td = _DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D))]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_flash_attention_matches_jax_kernel(case, dtype):
    B, Sq, Skv, H, K, D, causal, bq, bk = case
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Skv, H, K, D, dtype)
    want = jax_flash_attention(jq, jk, jv, causal=causal, force_pallas=True,
                               block_q=bq, block_k=bk)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    assert flash_attention.launches == before     # the CPU runs no kernel
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = _RTOL[_DTYPES[dtype][0]]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=5 * tol, rtol=tol)


def test_rows_that_see_no_key_follow_the_pallas_kernel():
    """Causal with Sq > Skv: queries 0..Sq-Skv-1 sit before every key. The
    Pallas kernel skips all their blocks and leaves them 0; the jnp oracle
    returns the mean of V there. The port follows the kernel (ROADMAP.md
    section 3's witness: B=1, Sq=48, Skv=16, H=2, K=1, D=8, blocks 16)."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 48, 16, 2, 1, 8, "float32")
    pallas = np.asarray(jax_flash_attention(
        jq, jk, jv, causal=True, force_pallas=True, block_q=16, block_k=16))
    oracle = np.asarray(jax_ref(jq, jk, jv, causal=True))
    got = flash_attention(q, k, v, causal=True, block_q=16, block_k=16)
    assert np.all(pallas[:, :32] == 0) and torch.all(got[:, :32] == 0)
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-6, rtol=2e-5)
    # the oracle disagrees on exactly those rows
    np.testing.assert_allclose(got[:, 32:].numpy(), oracle[:, 32:],
                               atol=1e-6, rtol=2e-5)
    assert np.abs(oracle[:, :32]).max() > 1e-3


def test_plain_version_is_the_oracle_where_every_row_sees_a_key():
    """Sq <= Skv: the port's plain version is the JAX oracle's function,
    and causal rows ignore the keys after them."""
    (jq, jk, jv), (q, k, v) = _inputs(2, 24, 40, 4, 2, 32, "float32", seed=1)
    got = flash_attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_ref(jq, jk, jv, causal=True)),
                               atol=1e-6, rtol=2e-5)
    k2, v2 = k.clone(), v.clone()
    k2[:, 30:], v2[:, 30:] = 1e4, -1e4            # after query 13's position
    again = flash_attention_ref(q, k2, v2, causal=True)
    assert torch.equal(again[:, :14], got[:, :14])


# (B, Sq, Skv, H, K, D, DV, causal): MLA's (qk, v) width pairs at smoke
# and at full width (192, 128), causal and not, Sq < Skv and Sq = 1
WIDTH_PAIR_CASES = [
    (1, 40, 40, 4, 4, 48, 32, True),
    (2, 24, 56, 4, 2, 48, 32, False),
    (1, 33, 33, 2, 2, 192, 128, True),
    (1, 1, 70, 2, 2, 192, 128, False),
]


@pytest.mark.parametrize("case", WIDTH_PAIR_CASES)
def test_plain_version_with_a_v_width_matches_jax_chunked_attention(case):
    """v narrower than q and k (MLA): the plain version — the function the
    CUDA kernel's (192, 128) instantiation is held to — against the JAX
    ``chunked_attention`` that ``mla_train`` runs past ``chunk_size``
    (the Pallas kernel takes one width), the queries the last Sq
    positions. fp32: atol 1e-5, rtol 2e-5."""
    B, Sq, Skv, H, K, D, DV, causal = case
    rng = np.random.default_rng(Sq + D)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, DV)))
    q_pos = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32),
                            (B, Sq))
    want = jax_chunked_attention(
        jnp.asarray(q.reshape(B, Sq, K, H // K, D)), jnp.asarray(k),
        jnp.asarray(v), scale=0.3, q_positions=jnp.asarray(q_pos),
        kv_positions=jnp.arange(Skv), causal=causal, chunk_size=16)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal, scale=0.3)
    assert got.shape == (B, Sq, H, DV)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(B, Sq, H, DV),
                               atol=1e-5, rtol=2e-5)
