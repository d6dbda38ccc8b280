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


# ------------------------------------------- the fp32 kernel's arithmetic
def _tf32_rna(x):
    """fp32 → TF32 (10 stored mantissa bits) rounding to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``: half a TF32 ulp added to the
    magnitude bits, then the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc32(x):
    """fp64 -> fp32 rounding toward zero, as the tensor cores round a sum."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _mma_3xtf32(acc, a, b, terms=3):
    """acc + a @ b as the kernel's mma's compute it: each fp32 operand split
    into hi = tf32(x) and lo = tf32(x - hi); for each 8-wide k-step, lo.hi,
    hi.lo, then hi.hi (``terms=1``: hi.hi alone, one TF32 product), each an
    mma that sums its 8 exact products and the accumulator wide and
    truncates the result to fp32."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    pairs = [(ah, bh)]
    if terms == 3:
        al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
        pairs = [(al, bh), (ah, bl), (ah, bh)]
    for k0 in range(0, a.shape[-1], 8):
        for x, y in pairs:
            acc = _trunc32(acc.double() + x[..., k0:k0 + 8].double()
                           @ y[..., k0:k0 + 8, :].double())
    return acc


def _kstep_order(D):
    """The d order of the kernel's S k-steps: k-step 2c holds d = 16c + 4t
    + {0, 1} and k-step 2c + 1 d = 16c + 4t + {2, 3}, t = 0..3."""
    return torch.tensor([16 * c + 4 * t + j for c in range(D // 16)
                         for half in (0, 2) for t in range(4)
                         for j in (half, half + 1)])


def _flash_3xtf32(q, k, v, causal, terms=3, seed=0, o_in_mma=False):
    """The fp32 kernel's arithmetic at the tensor level: scores and P.V in
    3xTF32 on truncating accumulators (``_mma_3xtf32``), the online softmax
    over the kernel's key tiles (32 keys, 16 at D = 192) in log2 units from
    a running max of -1e30, masked probabilities 0, every probability off
    by a relative 2^-21 with a random sign (twice ``ex2.approx``'s stated
    error), a tile's P.V summed from zero and folded into O by one fp32
    FMA (``o_in_mma``: O scaled, then accumulated in the mma's across the
    tiles), and the finish dividing by max(l, 1e-30)."""
    B, Sq, H, D = q.shape
    Skv, K, DV = k.shape[1], k.shape[2], v.shape[-1]
    G = H // K
    tile = 16 if D == 192 else 32
    gen = torch.Generator().manual_seed(seed)
    order = _kstep_order(D)
    qg = q[..., order].reshape(B, Sq, K, G, D).permute(0, 2, 3, 1, 4)
    kt = k[..., order].permute(0, 2, 3, 1)[:, :, None]      # b k 1 d t
    vt = v.permute(0, 2, 1, 3)[:, :, None]                   # b k 1 t dv
    pos = torch.arange(Sq) + (Skv - Sq)
    lim = (pos + 1).clamp(0, Skv) if causal else torch.full((Sq,), Skv)
    m = torch.full((B, K, G, Sq, 1), -1e30)
    l = torch.zeros((B, K, G, Sq, 1))
    o = torch.zeros((B, K, G, Sq, DV))
    scale_log2 = torch.tensor(D ** -0.5, dtype=torch.float32) \
        * torch.tensor(1.4426950408889634, dtype=torch.float32)
    for k0 in range(0, Skv, tile):
        keys = torch.arange(k0, min(k0 + tile, Skv))
        s = _mma_3xtf32(torch.zeros((B, K, G, Sq, len(keys))), qg,
                        kt[..., keys], terms) * scale_log2
        live = keys[None, :] < lim[:, None]
        s = torch.where(live, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.where(s > -5e29, torch.exp2(s - m_new), torch.tensor(0.0))
        sign = torch.randint(0, 2, p.shape, generator=gen) * 2 - 1
        p = p * (1 + sign * 2.0 ** -21)
        l = l * corr + p.sum(-1, keepdim=True)
        if o_in_mma:
            o = _mma_3xtf32(o * corr, p, vt[..., keys, :], terms)
        else:
            pv = _mma_3xtf32(torch.zeros_like(o), p, vt[..., keys, :], terms)
            o = (o.double() * corr.double() + pv.double()).float()
        m = m_new
    out = o / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, DV)


# (B, Sq, Skv, H, K, D, DV, causal) at smoke sizes: every width pair the
# kernel is built for, causal (Sq > Skv: dead rows) and non-causal
TF32_CASES = [
    (1, 70, 70, 4, 2, 32, 32, True),
    (2, 40, 100, 4, 2, 64, 64, False),
    (1, 90, 90, 4, 1, 128, 128, True),
    (1, 30, 75, 2, 2, 128, 128, False),
    (1, 50, 40, 2, 2, 256, 256, True),
    (1, 66, 66, 4, 4, 192, 128, True),
    (1, 20, 90, 2, 2, 192, 128, False),
]


@pytest.mark.parametrize("case", TF32_CASES)
def test_3xtf32_arithmetic_is_within_the_fp32_tolerance(case):
    """The tolerance argument for the fp32 kernel on the tensor cores,
    before any card run: its arithmetic (3xTF32 products on truncating
    accumulators, the online softmax over its key tiles, the exponential's
    error) stays within
    ``TOL["float32"]`` (atol 1e-4, rtol 4e-5) of the plain version, and
    rows that see no key are 0; one TF32 product alone does not stay
    within it at D >= 64."""
    B, Sq, Skv, H, K, D, DV, causal = case
    rng = np.random.default_rng(Sq + Skv + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, DV)))
    want = flash_attention_ref(q, k, v, causal=causal)
    got = _flash_3xtf32(q, k, v, causal)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=4e-5)
    if causal and Sq > Skv:
        assert torch.all(got[:, :Sq - Skv] == 0)
    if D >= 64:
        one = _flash_3xtf32(q, k, v, causal, terms=1)
        with pytest.raises(AssertionError):
            torch.testing.assert_close(one, want, atol=1e-4, rtol=4e-5)


def test_3xtf32_o_accumulated_in_the_mma_drifts_toward_zero():
    """The tensor cores truncate every sum, so O accumulated across the key
    tiles in the mma's shrinks one way, and more with every tile; a tile's
    P.V summed from zero and folded into O by one fp32 FMA, as the kernel
    does, keeps a drift that does not grow with the keys. Drift: the mean
    of (exact - got) * sign(exact) over the mean |exact|, against attention
    in fp64."""
    drift = {}
    for Skv in (256, 1024):
        rng = np.random.default_rng(3)
        q, k, v = (torch.from_numpy(rng.standard_normal(s)
                                    .astype(np.float32))
                   for s in ((1, 32, 2, 64), (1, Skv, 2, 64),
                             (1, Skv, 2, 64)))
        scores = torch.einsum("bshd,bthd->bhst", q.double(), k.double())
        exact = torch.einsum("bhst,bthd->bshd",
                             torch.softmax(scores / 8.0, -1), v.double())
        for o_in_mma in (False, True):
            got = _flash_3xtf32(q, k, v, False, o_in_mma=o_in_mma)
            drift[Skv, o_in_mma] = float(
                ((exact - got.double()) * exact.sign()).mean()
                / exact.abs().mean())
    assert drift[1024, True] > 2 * drift[256, True] > 0
    assert drift[1024, True] > 4 * drift[1024, False]
    assert drift[1024, False] < 1.5 * drift[256, False]


# ------------------------------------------------------- #9 as a custom op
# (B, Sq, Skv, H, K, D, DV, causal): equal and MLA-like width pairs,
# causal Sq == Skv, Sq < Skv and Sq > Skv, and non-causal
OP_CASES = [(2, 32, 32, 4, 2, 32, 32, True), (1, 20, 52, 4, 4, 16, 16, True),
            (1, 48, 16, 2, 1, 32, 32, True), (2, 24, 40, 6, 2, 48, 32, False),
            (1, 1, 64, 4, 4, 64, 64, False)]


def _op_inputs(B, Sq, Skv, H, K, D, DV, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype)
            for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, DV))]


@pytest.mark.parametrize("case", OP_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_entry_is_the_custom_op_and_its_cpu_path_the_parents(case, dtype):
    """The entry calls ``torch.ops.repro_torch.flash_attention``, whose CPU
    path gives the plain version's bits (what the entry returned before
    the op), counts no launch, and whose fake implementation gives the
    output's shape and dtype without data."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    B, Sq, Skv, H, K, D, DV, causal = case
    q, k, v = _op_inputs(B, Sq, Skv, H, K, D, DV, dtype)
    before = flash_attention.launches
    for scale in (None, 0.3):
        got = flash_attention(q, k, v, causal=causal, scale=scale)
        want = flash_attention_ref(q, k, v, causal=causal, scale=scale)
        assert torch.equal(got, want)
        op = torch.ops.repro_torch.flash_attention(
            q, k, v, causal, scale if scale else D ** -0.5)
        assert torch.equal(op, want)
    assert flash_attention.launches == before
    with FakeTensorMode() as fm:
        fq, fk, fv = (fm.from_tensor(t) for t in (q, k, v))
        out = flash_attention(fq, fk, fv, causal=causal)
    assert out.shape == (B, Sq, H, DV) and out.dtype == dtype


@pytest.mark.parametrize("case", OP_CASES)
def test_flop_formula_counts_the_pairs_a_row_sees(case):
    """``FlopCounterMode`` counts the op at 2 (D + DV) a (query, key) pair
    and query head, over the pairs the call computes — counted here by
    hand, query by query (a causal query at ``i + Skv - Sq`` sees the
    keys at or before it)."""
    from torch.utils.flop_counter import FlopCounterMode
    B, Sq, Skv, H, K, D, DV, causal = case
    q, k, v = _op_inputs(B, Sq, Skv, H, K, D, DV, torch.float32)
    with FlopCounterMode(display=False) as fc:
        flash_attention(q, k, v, causal=causal)
    pairs = 0
    for i in range(Sq):
        pairs += (sum(1 for j in range(Skv) if j <= i + Skv - Sq)
                  if causal else Skv)
    assert fc.get_total_flops() == 2 * (D + DV) * H * B * pairs


@pytest.mark.parametrize("kv_heads,heads_sharded", [(4, True), (1, False)])
def test_sharding_rule_keeps_batch_and_heads_where_they_divide(
        kv_heads, heads_sharded):
    """On a fake 2 × 2 world the op's DTensor rule keeps batch on ``data``
    and, where every mesh dim divides the KV heads, heads on ``model``;
    sequence and head width are never sharded."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_test_mesh, start_fake_world
    start_fake_world(4)
    try:
        mesh = make_test_mesh((2, 2), device_type="cpu")
        place = [Shard(0), Shard(2) if heads_sharded else Replicate()]
        with FakeTensorMode():
            q, k, v = (DTensor.from_local(
                torch.empty(2, 16, h // (2 if heads_sharded else 1), 32),
                mesh, place, run_check=False) for h in (4, kv_heads,
                                                         kv_heads))
            out = flash_attention(q, k, v, causal=True)
        assert out.shape == (4, 16, 4, 32)
        assert tuple(out.placements) == tuple(place)
    finally:
        dist.destroy_process_group()
