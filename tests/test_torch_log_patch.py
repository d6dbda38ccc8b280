"""The port's ``log_patch`` against the JAX package's, on the CPU.

Same seeded numpy inputs through the JAX Pallas kernel in interpret mode
(``force_pallas=True``) and through the port's entry, which takes CPU
tensors to its plain version — the function the CUDA kernel is held to,
bit for bit, on the card. A patch is a copy, so the two agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import log_patch as jax_log_patch
from repro.kernels.log_patch.ref import log_patch_ref as jax_ref
from repro_torch.kernels import log_patch

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("P,T,C,N", [(5, 8, 16, 20), (3, 16, 128, 64),
                                     (2, 4, 8, 1)])
def test_log_patch_matches_jax_kernel(P, T, C, N, dtype):
    """``tests/test_kernels.py``'s three shapes: in-range targets (with
    collisions at these sizes) and random valid flags."""
    jd, td = _DTYPES[dtype]
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((P, T, C)).astype(np.float32)
    pays = rng.standard_normal((N, C)).astype(np.float32)
    pg = rng.integers(0, P, N).astype(np.int32)
    sl = rng.integers(0, T, N).astype(np.int32)
    valid = rng.integers(0, 2, N).astype(np.int32)
    want = jax_log_patch(jnp.asarray(pool, jd), jnp.asarray(pays, jd),
                         jnp.asarray(pg), jnp.asarray(sl),
                         jnp.asarray(valid), force_pallas=True)
    before = log_patch.launches
    got = log_patch(torch.from_numpy(pool).to(td),
                    torch.from_numpy(pays).to(td), torch.from_numpy(pg),
                    torch.from_numpy(sl), torch.from_numpy(valid))
    assert log_patch.launches == before          # the CPU runs no kernel
    assert got.dtype == td
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


def test_log_patch_replay_order():
    """Later log records win on a shared target, and the input pool is
    left as it was (the patch is out of place)."""
    pool = torch.zeros(1, 4, 8)
    pays = torch.stack([torch.full((8,), 1.0), torch.full((8,), 2.0),
                        torch.full((8,), 3.0)])
    zeros = torch.zeros(3, dtype=torch.int32)
    out = log_patch(pool, pays, zeros, zeros,
                    torch.tensor([1, 1, 0], dtype=torch.int32))
    assert float(out[0, 0, 0]) == 2.0 and torch.all(out[0, 1:] == 0)
    assert torch.all(pool == 0)
    want = jax_log_patch(jnp.zeros((1, 4, 8)), jnp.asarray(pays.numpy()),
                         jnp.zeros(3, jnp.int32), jnp.zeros(3, jnp.int32),
                         jnp.asarray([1, 1, 0], jnp.int32),
                         force_pallas=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_out_of_range_records_follow_the_pallas_kernel():
    """The Pallas kernel clamps page and slot indices into range; the jnp
    oracle drops such records. The port follows the kernel (ROADMAP.md
    section 3's witness: pool (2, 4, 3), targets (5, 1), (-1, 9), (0, 0),
    payloads 1, 2, 3)."""
    pays = np.repeat(np.array([[1.0], [2.0], [3.0]], np.float32), 3, axis=1)
    pg = np.array([5, -1, 0], np.int32)
    sl = np.array([1, 9, 0], np.int32)
    args = (jnp.zeros((2, 4, 3)), jnp.asarray(pays), jnp.asarray(pg),
            jnp.asarray(sl))
    pallas = np.asarray(jax_log_patch(*args, force_pallas=True))
    oracle = np.asarray(jax_ref(*args))
    got = log_patch(torch.zeros(2, 4, 3), torch.from_numpy(pays),
                    torch.from_numpy(pg), torch.from_numpy(sl)).numpy()
    np.testing.assert_array_equal(got, pallas)
    assert got[1, 1, 0] == 1 and got[0, 3, 0] == 2 and got[0, 0, 0] == 3
    assert oracle[1, 1, 0] == 0 and oracle[0, 3, 0] == 0


# (P, T, C, N, what): the card kernel's edges that the Pallas kernel takes
_EDGES = [(3, 16, 64, 40, "one_target"), (4, 16, 64, 30, "all_invalid"),
          (9, 1, 256, 20, "T=1")]


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("P,T,C,N,what", _EDGES)
def test_log_patch_edges_match_jax_kernel(P, T, C, N, what, dtype):
    """Every record on one target (the last valid one wins), every record
    invalid (the pool comes back unchanged), and one-slot pages: the port
    against the Pallas kernel in interpret mode, bit for bit."""
    jd, td = _DTYPES[dtype]
    rng = np.random.default_rng(24)
    pool = rng.standard_normal((P, T, C)).astype(np.float32)
    pays = rng.standard_normal((N, C)).astype(np.float32)
    pg = rng.integers(0, P, N).astype(np.int32)
    sl = rng.integers(0, T, N).astype(np.int32)
    valid = (rng.random(N) < 0.8).astype(np.int32)
    if what == "one_target":
        pg[:], sl[:] = 1, T - 1
        valid[-3:] = [1, 0, 0]
    elif what == "all_invalid":
        valid[:] = 0
    want = jax_log_patch(jnp.asarray(pool, jd), jnp.asarray(pays, jd),
                         jnp.asarray(pg), jnp.asarray(sl),
                         jnp.asarray(valid), force_pallas=True)
    got = log_patch(torch.from_numpy(pool).to(td),
                    torch.from_numpy(pays).to(td), torch.from_numpy(pg),
                    torch.from_numpy(sl), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    if what == "one_target":
        np.testing.assert_array_equal(got[1, T - 1].float().numpy(),
                                      _np(jnp.asarray(pays[N - 3], jd)))
    elif what == "all_invalid":
        np.testing.assert_array_equal(got.float().numpy(),
                                      _np(jnp.asarray(pool, jd)))


@pytest.mark.parametrize("valid", [None, "flags"])
def test_log_patch_of_no_records_matches_jax(valid):
    """N = 0. Neither JAX path takes it (the Pallas kernel's record block
    cannot be empty, and the jnp oracle's scan indexes an empty axis while
    it traces), so the port's empty batch is held to the JAX kernel's batch
    of one invalid record, the same drain with nothing to apply: the pool
    comes back unchanged."""
    rng = np.random.default_rng(5)
    pool = rng.standard_normal((4, 16, 64)).astype(np.float32)
    idx = np.zeros((0,), np.int32)
    flags = None if valid is None else np.zeros((0,), np.int32)
    want = jax_log_patch(jnp.asarray(pool), jnp.ones((1, 64)),
                         jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32),
                         jnp.zeros(1, jnp.int32), force_pallas=True)
    got = log_patch(torch.from_numpy(pool), torch.zeros((0, 64)),
                    torch.from_numpy(idx), torch.from_numpy(idx),
                    None if flags is None else torch.from_numpy(flags))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), pool)
