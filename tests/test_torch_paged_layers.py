"""The port's multi-layer paged-attention entries against the JAX
package's oracles, on the CPU, and the kernel package's public names.

Same seeded inputs (``tests/test_kernels.py``'s input helpers) through the JAX
``*_layers_*_ref`` oracles and through the port's entries, which take CPU
tensors to their plain versions — the functions the CUDA kernels are held
to on the card. Tolerances are ``tests/test_kernels.py``'s. Then the pins
the card repeats bit for bit: layer ``l`` of a multi-layer call is the
single-layer entry on layer ``l``, and the multi-layer ragged entry at
``q_len == 1`` is the multi-layer decode entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jax_kernels
from repro.kernels.paged_attention.ref import (
    mla_paged_attention_layers_ragged_ref as jax_mla_layers_ref,
    paged_attention_layers_ragged_q8_ref as jax_q8_layers_ref,
    paged_attention_layers_ragged_ref as jax_ragged_layers_ref,
    paged_attention_layers_ref as jax_layers_ref)
import repro_torch.kernels as kernels
from repro_torch.kernels import (
    mla_paged_attention_layers_ragged, mla_paged_attention_ragged,
    paged_attention_layers, paged_attention_layers_ragged,
    paged_attention_layers_ragged_q8, paged_attention_ragged,
    paged_attention_ragged_q8)

from test_kernels import (LAYERS_CASES, RAGGED_CASES, _RTOL, _mla_inputs,
                          _q8_inputs, _ragged_inputs)

_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, dtype):
    tol = _RTOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=5 * tol, rtol=2 * tol)


def test_public_names_are_the_jax_packages():
    assert sorted(kernels.__all__) == sorted(jax_kernels.__all__)
    assert len(kernels.__all__) == 12
    assert {e.__name__ for e in kernels.ENTRIES} == set(kernels.__all__)


@pytest.mark.parametrize("case", LAYERS_CASES)
@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_layers_decode_matches_jax_oracle(case, dtype):
    L, B, H, K, D, T, P, MP = case
    jd = _DTYPES[dtype]
    rng = np.random.default_rng(5)
    q = jnp.asarray(rng.standard_normal((L, B, H, D)), jd)
    pk = jnp.asarray(rng.standard_normal((L, P, T, K, D)), jd)
    pv = jnp.asarray(rng.standard_normal((L, P, T, K, D)), jd)
    tbl = jnp.asarray(rng.integers(0, P, (B, MP)), jnp.int32)
    lens = jnp.asarray(rng.integers(1, T * MP, B), jnp.int32)
    got = paged_attention_layers(*map(_t, (q, pk, pv, tbl, lens)))
    _close(got, jax_layers_ref(q, pk, pv, tbl, lens), jd)


@pytest.mark.parametrize("case", RAGGED_CASES)
@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_layers_ragged_matches_jax_oracle(case, dtype):
    args = _ragged_inputs(case, _DTYPES[dtype])
    got = paged_attention_layers_ragged(*map(_t, args))
    _close(got, jax_ragged_layers_ref(*args), _DTYPES[dtype])
    q, pk, pv, tbl, lens, qls = map(_t, args)
    for l in range(q.shape[0]):              # layer l is the 1-layer entry
        assert torch.equal(got[l], paged_attention_ragged(
            q[l], pk[l], pv[l], tbl, lens, qls))


def test_layers_ragged_at_qlen1_is_bitwise_layers_decode():
    q, pk, pv, tbl, lens, _ = map(_t, _ragged_inputs(RAGGED_CASES[0],
                                                     jnp.float32, seed=13))
    lens = lens.clamp(min=1)
    ones = torch.ones_like(lens)
    r = paged_attention_layers_ragged(q[:, :, :1], pk, pv, tbl, lens, ones)
    d = paged_attention_layers(q[:, :, 0], pk, pv, tbl, lens)
    assert torch.equal(r[:, :, 0], d)


@pytest.mark.parametrize("seed", [31, 33])
def test_layers_q8_matches_jax_oracle(seed):
    args = _q8_inputs(seed)
    got = paged_attention_layers_ragged_q8(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_q8_layers_ref(
        *args)), atol=1e-4, rtol=4e-5)
    q, pk, pv, ks, vs, tbl, lens, qls = map(_t, args)
    for b in range(q.shape[1]):
        assert torch.all(got[:, b, int(qls[b]):] == 0)
    for l in range(q.shape[0]):
        assert torch.equal(got[l], paged_attention_ragged_q8(
            q[l], pk[l], pv[l], ks[l], vs[l], tbl, lens, qls))


@pytest.mark.parametrize("seed", [32, 36])
def test_layers_mla_matches_jax_oracle(seed):
    *args, scale = _mla_inputs(seed)
    got = mla_paged_attention_layers_ragged(*map(_t, args), scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_mla_layers_ref(
        *args, scale=scale)), atol=1e-4, rtol=4e-5)
    q_c, q_r, pc, pkr, tbl, lens, qls = map(_t, args)
    for b in range(q_c.shape[1]):
        assert torch.all(got[:, b, int(qls[b]):] == 0)
    for l in range(q_c.shape[0]):
        assert torch.equal(got[l], mla_paged_attention_ragged(
            q_c[l], q_r[l], pc[l], pkr[l], tbl, lens, qls, scale=scale))
