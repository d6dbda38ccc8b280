"""The port on the card: the hand-written CUDA kernels (dense, int8 and MLA
paged attention, one layer or all layers; flash attention; log patch; the
paged K/V write) against their plain PyTorch versions, and the pooled
serving path through them, long prompts included.

Every test here is marked ``cuda`` and skips when torch sees no GPU (the
decision is taken inside the ``cuda_device`` fixture, never at import).
The file imports only torch, numpy, the port, ``chip_smoke.py`` and
``tests/kv_write_cases.py``, so it runs on a machine without JAX:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.kernels as kernels
from repro_torch.configs import get_config
from repro_torch.kernels.build import c_entry
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.log_patch.ref import log_patch_ref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    kv_page_write_ref, mla_paged_attention_layers_ragged_ref,
    mla_paged_attention_ragged_ref, paged_attention_layers_ragged_q8_ref,
    paged_attention_layers_ragged_ref, paged_attention_ragged_q8_ref,
    paged_attention_ragged_ref)
from repro_torch.models import LM
from repro_torch.models.moe import apply_moe
from repro_torch.serving import Request, ServeConfig, ServingEngine

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
import kv_write_cases  # noqa: E402

# tests/test_kernels.py: atol 5·_RTOL, rtol 2·_RTOL
_TOL = {torch.float32: (1e-4, 4e-5), torch.bfloat16: (1e-1, 4e-2)}
# a bf16 output of fp32 math against the plain fp32 version on the same
# values: only the output's rounding (half a bf16 ulp, 2^-8 relative)
_TOL_BF16_VS_FP32 = (1e-5, 2 ** -8)
# tests/test_kernels.py's FLASH_CASES (that file imports JAX), plus a
# causal Sq > Skv case whose first 32 query rows see no key
# (B, Sq, Skv, H, K, D, causal, block_q, block_k)
FLASH_CASES = [
    (2, 128, 128, 8, 2, 64, True, 64, 64),
    (1, 100, 260, 4, 4, 32, True, 32, 64),
    (2, 64, 192, 6, 2, 128, False, 64, 64),
    (1, 256, 256, 4, 1, 128, True, 128, 128),
    (1, 37, 129, 2, 2, 256, True, 16, 32),
    (1, 48, 16, 2, 1, 32, True, 16, 16),
]


def _edge_inputs(seed=14):
    """One batch holding the contract's edge rows: a q_len == 0 row, a
    decode row, a chunk ending on a page boundary, a mid-page chunk."""
    B, Qm, H, K, D, T, P, MP = 4, 4, 8, 4, 64, 8, 24, 4
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, Qm, H, D)).astype(np.float32))
    pk = torch.from_numpy(rng.standard_normal((P, T, K, D)).astype(np.float32))
    pv = torch.from_numpy(rng.standard_normal((P, T, K, D)).astype(np.float32))
    tbl = torch.from_numpy(rng.permutation(P)[:B * MP].reshape(B, MP)
                           .astype(np.int32))
    lens = torch.tensor([6, 5, 2 * T, T * MP - 3], dtype=torch.int32)
    qls = torch.tensor([0, 1, T // 2, 3], dtype=torch.int32)
    return q, pk, pv, tbl, lens, qls


def _poison_dead(pk, pv, tbl, lens, T):
    """Overwrite every pool slot at or past each row's length, and point
    the table entries past each row's live pages at garbage (including
    out-of-range page numbers)."""
    pk, pv, tbl = pk.clone(), pv.clone(), tbl.clone()
    for b in range(tbl.shape[0]):
        live = -(-int(lens[b]) // T)
        for lp in range(tbl.shape[1]):
            phys = int(tbl[b, lp])
            start = lp * T
            if start >= int(lens[b]):
                pk[phys] = 1e6
                pv[phys] = -1e6
            elif start + T > int(lens[b]):
                pk[phys, int(lens[b]) - start:] = 1e6
                pv[phys, int(lens[b]) - start:] = -1e6
        tail = torch.tensor([-7, 10 ** 6, 3, 0], dtype=tbl.dtype)
        tbl[b, live:] = tail[:tbl.shape[1] - live].to(tbl.device)
    return pk, pv, tbl


def _q8_edge_inputs(seed=15):
    """The edge rows of :func:`_edge_inputs` over an int8 pool with bf16
    per-(token, head) scales."""
    q, pk, _, tbl, lens, qls = _edge_inputs(seed)
    rng = np.random.default_rng(seed)
    P, T, K, D = pk.shape
    pk = torch.from_numpy(rng.integers(-127, 128, (P, T, K, D), dtype=np.int8))
    pv = torch.from_numpy(rng.integers(-127, 128, (P, T, K, D), dtype=np.int8))
    ks = torch.from_numpy((rng.random((P, T, K)) * 0.1 + 0.01)
                          .astype(np.float32)).to(torch.bfloat16)
    vs = torch.from_numpy((rng.random((P, T, K)) * 0.1 + 0.01)
                          .astype(np.float32)).to(torch.bfloat16)
    return q, pk, pv, ks, vs, tbl, lens, qls


def _poison_dead_q8(pk, pv, ks, vs, tbl, lens):
    """:func:`_poison_dead` for an int8 pool: dead codes at ±127 and their
    scales at 1e6 (``tests/test_kernels.py``'s poison), stale tails."""
    T = pk.shape[1]
    ks, vs = ks.clone(), vs.clone()
    pk2, pv2, tbl2 = _poison_dead(pk.float(), pv.float(), tbl, lens, T)
    dead = pk2.abs() >= 1e6                     # (P, T, K, D)
    pk2 = torch.where(dead, 127.0, pk2).to(torch.int8)
    pv2 = torch.where(dead, -127.0, pv2).to(torch.int8)
    ks[dead[..., 0]] = 1e6
    vs[dead[..., 0]] = 1e6
    return pk2, pv2, ks, vs, tbl2


def _mla_edge_inputs(seed=16, dc=64, dr=32):
    """The edge rows of :func:`_edge_inputs` over a latent pool (no KV
    head axis): fp32 queries, a (P, T, dc) latent and a (P, T, dr) rope-key
    plane."""
    q, pk, _, tbl, lens, qls = _edge_inputs(seed)
    rng = np.random.default_rng(seed)
    B, Qm, H, _ = q.shape
    P, T = pk.shape[:2]
    f = lambda *s: torch.from_numpy(                          # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    return (f(B, Qm, H, dc), f(B, Qm, H, dr), f(P, T, dc), f(P, T, dr), tbl,
            lens, qls, float(1.0 / np.sqrt(dc + dr)))


def _poison_dead_mla(pc, pkr, tbl, lens):
    pc2, pkr2, tbl2 = _poison_dead(pc[:, :, None], pkr[:, :, None], tbl,
                                   lens, pc.shape[1])
    return pc2[:, :, 0], pkr2[:, :, 0], tbl2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels run only on the "
                    "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda_device, dtype):
    """Kernel vs plain version on the same card inputs, then the bitwise
    pins: padding slots are 0, dead pages and stale table tails change
    nothing, ragged at q_len == 1 is the decode entry."""
    q, pk, pv, tbl, lens, qls = (t.to(cuda_device) for t in _edge_inputs())
    q, pk, pv = (t.to(dtype) for t in (q, pk, pv))
    before = ops.paged_attention_ragged.launches
    out = ops.paged_attention_ragged(q, pk, pv, tbl, lens, qls)
    torch.cuda.synchronize()
    assert ops.paged_attention_ragged.launches == before + 1
    ref = paged_attention_ragged_ref(q, pk, pv, tbl, lens, qls)
    atol, rtol = _TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    for b in range(q.shape[0]):
        assert torch.all(out[b, int(qls[b]):] == 0)
    pk2, pv2, tbl2 = _poison_dead(pk, pv, tbl, lens, pk.shape[1])
    assert torch.equal(
        ops.paged_attention_ragged(q, pk2, pv2, tbl2, lens, qls), out)
    ones = torch.ones_like(qls)
    r1 = ops.paged_attention_ragged(q, pk, pv, tbl, lens, ones)
    d1 = ops.paged_attention(q[:, 0], pk, pv, tbl, lens)
    assert torch.equal(r1[:, 0], d1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q8_kernel_matches_plain_version(cuda_device, dtype):
    """The int8 kernel against its plain version (dequantized in fp32, as
    the kernel does), then the pins: padding 0, poisoned dead codes and
    scales change no bit, ragged at q_len == 1 is the int8 decode entry."""
    q, pk, pv, ks, vs, tbl, lens, qls = (
        t.to(cuda_device) for t in _q8_edge_inputs())
    q = q.to(dtype)
    before = ops.paged_attention_ragged_q8.launches
    out = ops.paged_attention_ragged_q8(q, pk, pv, ks, vs, tbl, lens, qls)
    torch.cuda.synchronize()
    assert ops.paged_attention_ragged_q8.launches == before + 1
    ref = paged_attention_ragged_q8_ref(q.float(), pk, pv, ks, vs, tbl, lens,
                                        qls)
    atol, rtol = _TOL[dtype]
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol)
    for b in range(q.shape[0]):
        assert torch.all(out[b, int(qls[b]):] == 0)
    poisoned = _poison_dead_q8(pk, pv, ks, vs, tbl, lens)
    assert torch.equal(ops.paged_attention_ragged_q8(
        q, *poisoned[:4], poisoned[4], lens, qls), out)
    ones = torch.ones_like(qls)
    r1 = ops.paged_attention_ragged_q8(q, pk, pv, ks, vs, tbl, lens, ones)
    d1 = ops.paged_attention_q8(q[:, 0], pk, pv, ks, vs, tbl, lens)
    assert torch.equal(r1[:, 0], d1)


@pytest.mark.cuda
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dc,dr", [(64, 32), (512, 64)])
def test_mla_kernel_matches_plain_version(cuda_device, pool_dtype, dc, dr):
    """The MLA kernel against its plain version on the same pool values
    (fp32 math, fp32 output), then the pins: padding 0, dead pages and
    stale tails change no bit, ragged at q_len == 1 is the decode entry."""
    q_c, q_r, pc, pkr, tbl, lens, qls, scale = (
        t.to(cuda_device) if isinstance(t, torch.Tensor) else t
        for t in _mla_edge_inputs(dc=dc, dr=dr))
    pc, pkr = pc.to(pool_dtype), pkr.to(pool_dtype)
    before = ops.mla_paged_attention_ragged.launches
    out = ops.mla_paged_attention_ragged(q_c, q_r, pc, pkr, tbl, lens, qls,
                                         scale=scale)
    torch.cuda.synchronize()
    assert ops.mla_paged_attention_ragged.launches == before + 1
    ref = mla_paged_attention_ragged_ref(q_c, q_r, pc.float(), pkr.float(),
                                         tbl, lens, qls, scale=scale)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=4e-5)
    for b in range(q_c.shape[0]):
        assert torch.all(out[b, int(qls[b]):] == 0)
    pc2, pkr2, tbl2 = _poison_dead_mla(pc, pkr, tbl, lens)
    assert torch.equal(ops.mla_paged_attention_ragged(
        q_c, q_r, pc2, pkr2, tbl2, lens, qls, scale=scale), out)
    ones = torch.ones_like(qls)
    r1 = ops.mla_paged_attention_ragged(q_c, q_r, pc, pkr, tbl, lens, ones,
                                        scale=scale)
    d1 = ops.mla_paged_attention(q_c[:, 0], q_r[:, 0], pc, pkr, tbl, lens,
                                 scale=scale)
    assert torch.equal(r1[:, 0], d1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kv_cache_dtype", [
    ("internlm2-1.8b-smoke", "int8"),
    ("deepseek-v2-236b-noexperts-smoke", "native"),
    ("deepseek-v2-236b-smoke", "native"), ("arctic-480b-smoke", "native"),
    ("gemma-7b-smoke", "native"), ("minicpm-2b-smoke", "native"),
    ("starcoder2-15b-smoke", "native")])
def test_family_serving_on_card_matches_sequential(cuda_device, arch,
                                                   kv_cache_dtype):
    """Smoke-sized int8, MLA, MoE (at no-drop capacity) and dense-config
    serving on the card: the fused path (one family ragged launch per
    layer and step) and the unfused path (the family decode entry) are
    token-identical to the dense sequential reference, and mirror-free."""
    cfg = chip_smoke.cut(get_config(arch), None, no_drop=True)
    model = LM(cfg, device=cuda_device, kv_cache_dtype=kv_cache_dtype).init(
        torch.Generator(cuda_device).manual_seed(0))
    if cfg.mla is not None:
        ragged, decode = (ops.mla_paged_attention_ragged,
                          ops.mla_paged_attention)
    elif kv_cache_dtype == "int8":
        ragged, decode = ops.paged_attention_ragged_q8, ops.paged_attention_q8
    else:
        ragged, decode = ops.paged_attention_ragged, ops.paged_attention
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (8, 12, 8)]

    def run(method, **kw):
        reqs = [Request(rid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        eng = ServingEngine(model, ServeConfig(max_len=32, page_tokens=8,
                                               **kw), device=cuda_device)
        getattr(eng, method)(reqs)
        return [r.generated for r in reqs], eng.stats()

    ref, _ = run("generate_sequential")
    ops.reset_launch_counts()
    fused, s = run("generate", prefill_chunk_tokens=5)
    assert fused == ref and s["mirror_d2h_bytes"] == 0
    assert ragged.launches == cfg.num_layers * s["step_calls"]
    unfused, _ = run("generate", prefill_chunk_tokens=5, fuse_ticks=False)
    assert unfused == ref and decode.launches > 0


@pytest.mark.cuda
def test_pooled_serving_on_card_matches_sequential(cuda_device):
    """Smoke-sized pooled, fused serving on the card (through the ragged
    kernel) and the unfused path (through the decode kernel) are
    token-identical to the dense sequential reference."""
    cfg = get_config("internlm2-1.8b-smoke")
    model = LM(cfg, device=cuda_device).init(
        torch.Generator(cuda_device).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (8, 12, 8)]

    def run(method, **kw):
        reqs = [Request(rid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        eng = ServingEngine(model, ServeConfig(max_len=32, page_tokens=8,
                                               **kw), device=cuda_device)
        getattr(eng, method)(reqs)
        return [r.generated for r in reqs], eng.stats()

    ref, _ = run("generate_sequential")
    ops.reset_launch_counts()
    fused, s = run("generate", prefill_chunk_tokens=5)
    assert fused == ref and s["mirror_d2h_bytes"] == 0
    assert ops.paged_attention_ragged.launches == \
        cfg.num_layers * s["step_calls"]
    unfused, _ = run("generate", prefill_chunk_tokens=5, fuse_ticks=False)
    assert unfused == ref and ops.paged_attention.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(cuda_device, case, dtype):
    """The flash kernel against its plain version on the same card inputs
    (a bf16 output also against the plain fp32 version, to half an ulp);
    rows that see no key are exactly 0."""
    B, Sq, Skv, H, K, D, causal, bq, bk = case
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device, dtype)
               for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D)))
    before = kernels.flash_attention.launches
    out = kernels.flash_attention(q, k, v, causal=causal, block_q=bq,
                                  block_k=bk)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    atol, rtol = _TOL[dtype]
    ref = flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    ref32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                causal=causal)
    atol, rtol = _TOL_BF16_VS_FP32 if dtype == torch.bfloat16 \
        else _TOL[torch.float32]
    torch.testing.assert_close(out.float(), ref32, atol=atol, rtol=rtol)
    if causal and Sq > Skv:
        assert torch.all(out[:, :Sq - Skv] == 0)
    assert torch.equal(kernels.flash_attention(q, k, v, causal=causal), out)


@pytest.mark.cuda
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pay_dtype", [torch.float32, torch.bfloat16])
def test_log_patch_kernel_is_plain_version(cuda_device, pool_dtype,
                                           pay_dtype):
    """Colliding targets (the later record wins), skipped records and
    out-of-range indices (clamped): bit for bit the plain version."""
    P, T, C, N = 6, 8, 40, 50
    rng = np.random.default_rng(4)
    pool = torch.from_numpy(rng.standard_normal((P, T, C)).astype(
        np.float32)).to(cuda_device, pool_dtype)
    pays = torch.from_numpy(rng.standard_normal((N, C)).astype(
        np.float32)).to(cuda_device, pay_dtype)
    pg = torch.from_numpy(rng.integers(0, 3, N).astype(np.int32))
    sl = torch.from_numpy(rng.integers(0, 3, N).astype(np.int32))
    pg[7], sl[9] = P + 3, -2
    valid = torch.from_numpy(rng.integers(0, 2, N).astype(np.int32))
    args = (pool, pays, pg.to(cuda_device), sl.to(cuda_device),
            valid.to(cuda_device))
    before = kernels.log_patch.launches
    out = kernels.log_patch(*args)
    torch.cuda.synchronize()
    assert kernels.log_patch.launches == before + 1
    assert torch.equal(out, log_patch_ref(*args))
    assert torch.equal(kernels.log_patch(*args[:4]), log_patch_ref(*args[:4]))


def _layered(family, L=3):
    """Per-layer edge inputs of a family stacked into an L-layer batch:
    (entry, plain version, layered args, shared args, kwargs, decode
    entry at Qmax = 1 or None)."""
    if family == "mla":
        per = [_mla_edge_inputs(seed=40 + l) for l in range(L)]
        *_, tbl, lens, qls, scale = per[0]
        layered = tuple(torch.stack([p[i] for p in per]) for i in range(4))
        return (kernels.mla_paged_attention_layers_ragged,
                mla_paged_attention_layers_ragged_ref, layered,
                (tbl, lens, qls), {"scale": scale}, None)
    if family == "int8":
        per = [_q8_edge_inputs(seed=40 + l) for l in range(L)]
        *_, tbl, lens, qls = per[0]
        layered = tuple(torch.stack([p[i] for p in per]) for i in range(5))
        return (kernels.paged_attention_layers_ragged_q8,
                paged_attention_layers_ragged_q8_ref, layered,
                (tbl, lens, qls), {}, None)
    per = [_edge_inputs(seed=40 + l) for l in range(L)]
    *_, tbl, lens, qls = per[0]
    layered = tuple(torch.stack([p[i] for p in per]) for i in range(3))
    return (kernels.paged_attention_layers_ragged,
            paged_attention_layers_ragged_ref, layered, (tbl, lens, qls), {},
            kernels.paged_attention_layers)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "int8", "mla"])
def test_layers_kernels_are_the_single_layer_kernels(cuda_device, family):
    """Each multi-layer entry against its plain version, then the pins:
    layer l is bit for bit the single-layer entry on layer l, padding
    slots are 0, and (dense) the ragged entry at q_len == 1 is the
    multi-layer decode entry."""
    entry, plain, layered, shared, kw, decode = _layered(family)
    layered = tuple(t.to(cuda_device) for t in layered)
    shared = tuple(t.to(cuda_device) for t in shared)
    single = {"dense": ops.paged_attention_ragged,
              "int8": ops.paged_attention_ragged_q8,
              "mla": ops.mla_paged_attention_ragged}[family]
    before = entry.launches
    out = entry(*layered, *shared, **kw)
    torch.cuda.synchronize()
    assert entry.launches == before + 1
    torch.testing.assert_close(out, plain(*layered, *shared, **kw),
                               atol=1e-4, rtol=4e-5)
    for l in range(out.shape[0]):
        assert torch.equal(out[l], single(*(t[l] for t in layered), *shared,
                                          **kw))
    qls = shared[2]
    for b in range(out.shape[1]):
        assert torch.all(out[:, b, int(qls[b]):] == 0)
    if decode is not None:
        q, pk, pv = layered
        ones = torch.ones_like(qls)
        r1 = entry(q, pk, pv, shared[0], shared[1], ones)
        assert torch.equal(r1[:, :, 0], decode(q[:, :, 0], pk, pv,
                                               shared[0], shared[1]))


@pytest.mark.cuda
def test_long_prompt_serving_on_card_matches_sequential(cuda_device):
    """Prompts past chunk_size prefill whole through the flash kernel (one
    launch per layer and long prompt), then decode pooled and fused:
    token-identical to the sequential reference, mirror-free."""
    cfg = get_config("internlm2-1.8b-smoke")
    model = LM(cfg, device=cuda_device, chunk_size=8).init(
        torch.Generator(cuda_device).manual_seed(0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (20, 12, 6)]

    def run(method):
        reqs = [Request(rid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        eng = ServingEngine(model, ServeConfig(max_len=32, page_tokens=8),
                            device=cuda_device)
        getattr(eng, method)(reqs)
        return [r.generated for r in reqs], eng.stats()

    ref, _ = run("generate_sequential")
    kernels.reset_launch_counts()
    got, s = run("generate")
    assert got == ref and s["mirror_d2h_bytes"] == 0
    assert kernels.flash_attention.launches == 2 * cfg.num_layers
    assert ops.paged_attention_ragged.launches == \
        cfg.num_layers * s["step_calls"]


# ---------------------------------------------- split-KV paged attention
def _pages_per_part():
    """The pages of one split-KV partition, as the built kernel has it."""
    return c_entry(ops.SOURCE, "paged_attention_pages_per_part", [])()


def _split_inputs(family, dtype, ctx, q_lens, *, L=None, H=4, K=2, D=128,
                  T=16, seed=21):
    """Pool, table and queries for rows of the given contexts (tokens
    before the chunk) and chunk lengths; the table is wide enough for the
    longest row. Returns (q, planes, table, lengths, q_lens)."""
    rng = np.random.default_rng(seed)
    B, Qm = len(ctx), max(max(q_lens), 1)
    lengths = np.asarray(ctx) + np.asarray(q_lens)
    MP = int(-(-lengths.max() // T)) + 1
    P = B * MP + 3
    lead = (L,) if L else ()
    f = lambda *s: torch.from_numpy(                          # noqa: E731
        rng.standard_normal(lead + s).astype(np.float32))
    q = f(B, Qm, H, D).to(dtype)
    table = torch.from_numpy(rng.permutation(P)[:B * MP].reshape(B, MP)
                             .astype(np.int32))
    if family == "int8":
        codes = lambda: torch.from_numpy(                     # noqa: E731
            rng.integers(-127, 128, lead + (P, T, K, D), dtype=np.int8))
        scl = lambda: torch.from_numpy(                       # noqa: E731
            (rng.random(lead + (P, T, K)) * 0.1 + 0.01).astype(np.float32)
        ).to(torch.bfloat16)
        planes = (codes(), codes(), scl(), scl())
    else:
        planes = (f(P, T, K, D).to(dtype), f(P, T, K, D).to(dtype))
    return (q, planes, table, torch.tensor(lengths, dtype=torch.int32),
            torch.tensor(q_lens, dtype=torch.int32))


def _ragged(family, layered=False):
    if family == "int8":
        return (kernels.paged_attention_layers_ragged_q8 if layered
                else ops.paged_attention_ragged_q8)
    return (kernels.paged_attention_layers_ragged if layered
            else ops.paged_attention_ragged)


def _decode(family):
    return ops.paged_attention_q8 if family == "int8" else ops.paged_attention


def _plain(family):
    return (paged_attention_ragged_q8_ref if family == "int8"
            else paged_attention_ragged_ref)


def _bits(t):
    """The raw bits of a float tensor (so -0.0 and +0.0 differ)."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


_FAMILIES = [("dense", torch.float32), ("dense", torch.bfloat16),
             ("int8", torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("family,dtype", _FAMILIES)
def test_split_kv_partition_edges_match_plain_version(cuda_device, family,
                                                      dtype):
    """Decode rows whose contexts end exactly on a partition boundary, one
    page past it, one token past it, and at 258 pages, and a 128-query chunk
    crossing a boundary: against the plain version, and every decode row bit
    for bit the ragged launch at q_len == 1."""
    T = 16
    edge = _pages_per_part() * T
    ctx = [edge - 1, edge + T - 1, edge, 2 * edge - 1, 258 * T - 1, 5]
    q, planes, tbl, lens, qls = (
        t.to(cuda_device) if isinstance(t, torch.Tensor) else
        tuple(x.to(cuda_device) for x in t)
        for t in _split_inputs(family, dtype, ctx, [1] * len(ctx)))
    out = _decode(family)(q[:, 0], *planes, tbl, lens)
    torch.cuda.synchronize()
    q32 = q.float()
    ref = _plain(family)(q32 if family == "int8" else q, *planes, tbl, lens,
                         qls)[:, 0]
    atol, rtol = _TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    r1 = _ragged(family)(q, *planes, tbl, lens, qls)
    assert torch.equal(_bits(r1[:, 0]), _bits(out))
    # a 128-query chunk whose queries straddle pages 7/8 and 15/16
    q2, planes2, tbl2, lens2, qls2 = (
        t.to(cuda_device) if isinstance(t, torch.Tensor) else
        tuple(x.to(cuda_device) for x in t)
        for t in _split_inputs(family, dtype, [edge - 40, 3], [128, 0],
                               seed=22))
    out2 = _ragged(family)(q2, *planes2, tbl2, lens2, qls2)
    ref2 = _plain(family)(q2.float() if family == "int8" else q2, *planes2,
                          tbl2, lens2, qls2)
    torch.testing.assert_close(out2.float(), ref2.float(), atol=atol,
                               rtol=rtol)
    assert torch.all(out2[1] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("family,dtype", _FAMILIES)
def test_split_kv_row_is_the_row_alone(cuda_device, family, dtype):
    """A chunk whose early queries see only the first partition while its
    last ones reach the second: each query's output is bit for bit the same
    query decoded alone at its own length (the later partitions are skipped
    for it, not added with weight 0), and committing one more slot
    reproduces the chunk as a bitwise prefix."""
    T = 16
    edge = _pages_per_part() * T
    q, planes, tbl, lens, qls = (
        t.to(cuda_device) if isinstance(t, torch.Tensor) else
        tuple(x.to(cuda_device) for x in t)
        for t in _split_inputs(family, dtype, [edge - 12], [16], seed=23))
    out = _ragged(family)(q, *planes, tbl, lens, qls)
    pos0 = int(lens[0]) - int(qls[0])
    for i in range(int(qls[0])):
        alone = _decode(family)(q[:, i], *planes, tbl,
                                torch.full_like(lens, pos0 + i + 1))
        assert torch.equal(_bits(out[:, i]), _bits(alone)), i
    shorter = _ragged(family)(q[:, :15], *planes, tbl, lens - 1, qls - 1)
    assert torch.equal(_bits(out[:, :15]), _bits(shorter))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_kv_negative_zero_values(cuda_device, dtype):
    """V of -0.0 everywhere over three partitions: every output is 0 and
    its bits do not depend on the launch (ragged vs decode, a row vs the
    same row alone)."""
    T = 16
    edge = _pages_per_part() * T
    q, (pk, pv), tbl, lens, qls = (
        t.to(cuda_device) if isinstance(t, torch.Tensor) else
        tuple(x.to(cuda_device) for x in t)
        for t in _split_inputs("dense", dtype, [2 * edge + 5, 7], [4, 1],
                               seed=24))
    pv = torch.full_like(pv, -0.0)
    out = ops.paged_attention_ragged(q, pk, pv, tbl, lens, qls)
    assert torch.all(out == 0)
    for i in range(4):
        alone = ops.paged_attention(q[:, i], pk, pv, tbl,
                                    lens - int(qls[0]) + i + 1)
        assert torch.equal(_bits(out[0, i]), _bits(alone[0]))
    d1 = ops.paged_attention(q[:, 0], pk, pv, tbl, lens)
    r1 = ops.paged_attention_ragged(q, pk, pv, tbl, lens,
                                    torch.ones_like(qls))
    assert torch.equal(_bits(r1[:, 0]), _bits(d1))


@pytest.mark.cuda
@pytest.mark.parametrize("qmax", [1, 128])
@pytest.mark.parametrize("family,dtype", _FAMILIES)
def test_split_kv_pins_over_24_layers(cuda_device, family, dtype, qmax):
    """The multi-layer entry at L = 24 over rows of 0 to 3 partitions:
    against its plain version; layer l bit for bit the single-layer
    launch; padding slots 0; q_len == 1 rows bit for bit the decode
    entry."""
    L, T = 24, 16
    ctx = [0, 40, 130, 300] if qmax > 1 else [0, 17, 128, 300]
    qls_ = [qmax, 1, 57, 0] if qmax > 1 else [1, 1, 1, 1]
    q, planes, tbl, lens, qls = (
        t.to(cuda_device) if isinstance(t, torch.Tensor) else
        tuple(x.to(cuda_device) for x in t)
        for t in _split_inputs(family, dtype, ctx, qls_, L=L, seed=25))
    entry = _ragged(family, layered=True)
    out = entry(q, *planes, tbl, lens, qls)
    torch.cuda.synchronize()
    plain = (paged_attention_layers_ragged_q8_ref if family == "int8"
             else paged_attention_layers_ragged_ref)
    ref = plain(q.float() if family == "int8" else q, *planes, tbl, lens, qls)
    atol, rtol = _TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    for l in range(L):
        single = _ragged(family)(q[l], *(p[l] for p in planes), tbl, lens,
                                 qls)
        assert torch.equal(_bits(out[l]), _bits(single)), l
    for b in range(q.shape[1]):
        assert torch.all(out[:, b, int(qls[b]):] == 0)
    ones = (qls == 1).nonzero().flatten()
    for l in (0, L - 1):
        d1 = _decode(family)(q[l][:, 0], *(p[l] for p in planes), tbl, lens)
        assert torch.equal(_bits(out[l][ones, 0]), _bits(d1[ones]))


@pytest.mark.cuda
@pytest.mark.parametrize("layers,width", [(1, 1100), (24, 0)])
@pytest.mark.parametrize("family,dtype", _FAMILIES[1:])
def test_split_kv_scratch_passes_change_no_bit(cuda_device, family, dtype,
                                               layers, width):
    """A launch whose split-KV scratch would pass the cap runs in passes
    (over row tiles of one row for a 1100-page table, over (layer, row)
    slices at 24 layers) and gives the bits of a launch that needs one
    pass: the same rows under a table cut to the live pages, or each
    layer launched alone."""
    H, K, D, Qm = 16, 8, 128, 128
    q, planes, tbl, lens, qls = (
        t.to(cuda_device) if isinstance(t, torch.Tensor) else
        tuple(x.to(cuda_device) for x in t)
        for t in _split_inputs(family, dtype, [300, 1000 if width else 90],
                               [Qm, 50], L=layers if layers > 1 else None,
                               H=H, K=K, D=D, seed=26))
    G, MP = H // K, tbl.shape[1]
    one_pass = lambda L, mp: (L * len(lens) * K * Qm * G          # noqa: E731
                              * -(-mp // _pages_per_part()) * (D + 2))
    if layers > 1:
        assert ops.scratch_floats(layers, 2, Qm, H, K, D, MP) < \
            one_pass(layers, MP)
        out = _ragged(family, layered=True)(q, *planes, tbl, lens, qls)
        for l in range(layers):
            single = _ragged(family)(q[l], *(p[l] for p in planes), tbl,
                                     lens, qls)
            assert torch.equal(_bits(out[l]), _bits(single)), l
        return
    wide = torch.cat([tbl, tbl[:, :1].repeat(1, width - MP)], dim=1)
    assert ops.scratch_floats(1, 2, Qm, H, K, D, width) < one_pass(1, width)
    assert ops.scratch_floats(1, 2, Qm, H, K, D, MP) == one_pass(1, MP)
    out = _ragged(family)(q, *planes, wide, lens, qls)
    narrow = _ragged(family)(q, *planes, tbl, lens, qls)
    assert torch.equal(_bits(out), _bits(narrow))
    ref = _plain(family)(q.float() if family == "int8" else q, *planes, tbl,
                         lens, qls)
    atol, rtol = _TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


# ------------------------------------------------ log patch: edges
def _log_patch_inputs(case, dev):
    """(args, route the kernel must take) of a #10 edge case, made with
    numpy from a seed: pool (P, T, C), payloads (N, C), page and slot
    indices, valid flags (int32 on the card)."""
    rng = np.random.default_rng(24)
    P, T, C, N = case["shape"]
    pool_dt, pay_dt = case.get("dtypes", (torch.bfloat16, torch.bfloat16))
    pool = torch.from_numpy(rng.standard_normal((P, T, C)).astype(
        np.float32)).to(dev, pool_dt)
    if case.get("offset"):          # a pool view one element into its buffer
        flat = torch.from_numpy(rng.standard_normal(P * T * C + 1).astype(
            np.float32)).to(dev, pool_dt)
        pool = flat[1:].view(P, T, C)
    pays = torch.from_numpy(rng.standard_normal((N, C)).astype(
        np.float32)).to(dev, pay_dt)
    pg = rng.integers(0, case.get("pages", P), N).astype(np.int32)
    sl = rng.integers(0, case.get("slots", T), N).astype(np.int32)
    valid = (rng.random(N) < case.get("p_valid", 0.8)).astype(np.int32)
    if case.get("one_target"):      # every record on (page 1, slot T - 1)
        pg[:], sl[:] = min(1, P - 1), T - 1
        valid[-3:] = [1, 0, 0]      # ... the last valid one is N - 3
    return ((pool, pays, torch.from_numpy(pg).to(dev),
             torch.from_numpy(sl).to(dev), torch.from_numpy(valid).to(dev)),
            case.get("route", "vector"))


LOG_PATCH_EDGES = {
    "N=0": dict(shape=(4, 16, 64, 0)),
    "one_target": dict(shape=(3, 16, 64, 40), one_target=True),
    "all_invalid": dict(shape=(4, 16, 64, 30), p_valid=0.0),
    "T=1": dict(shape=(9, 1, 256, 20)),
    "T=64": dict(shape=(3, 64, 128, 100)),
    "row_not_16B": dict(shape=(4, 8, 12, 20), route="scalar"),
    "row_not_16B_fp32": dict(shape=(4, 8, 3, 20), route="scalar",
                             dtypes=(torch.float32, torch.float32)),
    "unaligned_view": dict(shape=(4, 8, 64, 20), offset=True,
                           route="scalar"),
    "fp32_into_bf16": dict(shape=(5, 16, 128, 60),
                           dtypes=(torch.bfloat16, torch.float32)),
    "bf16_into_fp32": dict(shape=(5, 16, 128, 60),
                           dtypes=(torch.float32, torch.bfloat16)),
    "N=4096_collisions": dict(shape=(8, 16, 256, 4096), pages=3, slots=4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LOG_PATCH_EDGES))
def test_log_patch_kernel_edges(cuda_device, name):
    """#10's winner table and both routes at their edges: N = 0, every
    record on one target (the last valid one wins), all records invalid,
    T = 1 and 64, rows that are not a multiple of 16 bytes and a pool view
    at an unaligned offset (scalar route), fp32 payloads into a bf16 pool
    and back, N = 4096 on 12 targets. Bit for bit the plain version, with
    and without the valid flags, in one launch each."""
    from repro_torch.kernels.log_patch.ops import route
    args, want_route = _log_patch_inputs(LOG_PATCH_EDGES[name], cuda_device)
    before = kernels.log_patch.launches
    out = kernels.log_patch(*args)
    torch.cuda.synchronize()
    assert kernels.log_patch.launches == before + 1
    assert route(args[0], args[1], out) == want_route
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    want = log_patch_ref(*args)
    assert torch.equal(_bits(out), _bits(want))
    if name == "one_target":
        assert torch.equal(out[1, -1], args[1][-3].to(out.dtype))
    if name in ("N=0", "all_invalid"):
        assert torch.equal(_bits(out), _bits(args[0]))
    assert torch.equal(_bits(kernels.log_patch(*args[:4])),
                       _bits(log_patch_ref(*args[:4])))


# ------------------------------------------------ flash attention, bf16
# (B, Sq, Skv, H, K, D, causal): Sq * G not a multiple of the 64-row query
# tile, every head dim, GQA 1 and 8, non-causal, Sq > Skv dead rows
FLASH_BF16_CASES = [
    (1, 100, 100, 8, 1, 32, True),
    (2, 77, 77, 4, 4, 64, True),
    (1, 130, 200, 8, 1, 128, False),
    (1, 33, 300, 16, 2, 128, True),
    (1, 200, 150, 2, 2, 256, True),
    (1, 96, 40, 8, 1, 64, True),
    (1, 70, 70, 8, 8, 256, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BF16_CASES)
def test_flash_bf16_tensor_core_kernel(cuda_device, case):
    """The bf16 tensor-core kernel against its plain version and, to half
    a bf16 ulp, the plain fp32 version on the same values; rows that see no
    key are exactly 0; the last queries' rows are bit for bit the same when
    fewer queries tile the call differently."""
    B, Sq, Skv, H, K, D, causal = case
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device, torch.bfloat16)
               for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D)))
    out = kernels.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    atol, rtol = _TOL[torch.bfloat16]
    torch.testing.assert_close(
        out.float(), flash_attention_ref(q, k, v, causal=causal).float(),
        atol=atol, rtol=rtol)
    ref32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                causal=causal)
    atol, rtol = _TOL_BF16_VS_FP32
    torch.testing.assert_close(out.float(), ref32, atol=atol, rtol=rtol)
    if causal and Sq > Skv:
        assert torch.all(out[:, :Sq - Skv] == 0)
    tail = Sq - 29
    part = kernels.flash_attention(q[:, -tail:].contiguous(), k, v,
                                   causal=causal)
    assert torch.equal(_bits(part), _bits(out[:, -tail:]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BF16_CASES)
def test_flash_fp32_tensor_core_kernel(cuda_device, case):
    """The fp32 kernel (3xTF32 on the tensor cores) at the bf16 kernel's
    cases: within the fp32 tolerance of its plain version; rows that see no
    key are exactly 0; the last queries' rows are bit for bit the same when
    fewer queries tile the call differently; views at an offset that is
    not 16-byte aligned give the same bits."""
    B, Sq, Skv, H, K, D, causal = case
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device)
               for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D)))
    out = kernels.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    atol, rtol = _TOL[torch.float32]
    torch.testing.assert_close(
        out, flash_attention_ref(q, k, v, causal=causal), atol=atol,
        rtol=rtol)
    if causal and Sq > Skv:
        assert torch.all(out[:, :Sq - Skv] == 0)
    tail = Sq - 29
    part = kernels.flash_attention(q[:, -tail:].contiguous(), k, v,
                                   causal=causal)
    assert torch.equal(_bits(part), _bits(out[:, -tail:]))
    # contiguous views one float past an aligned base (the kernel stages
    # with 16-byte copies): the same bits as the aligned tensors
    views = []
    for t in (q, k, v):
        buf = torch.empty(t.numel() + 1, device=cuda_device)
        buf[1:].copy_(t.flatten())
        views.append(buf[1:].view(t.shape))
    assert all(t.data_ptr() % 16 for t in views)
    odd = kernels.flash_attention(*views, causal=causal)
    assert torch.equal(_bits(odd), _bits(out))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D,DV", [(32, 32), (64, 64), (128, 128), (256, 256),
                                  (192, 128)])
def test_flash_fp32_kernel_at_every_width_pair(cuda_device, D, DV, causal):
    """Each (qk, v) width pair the fp32 kernel is built for (its key tile
    and shared memory differ by pair), GQA 4, Sq * G not a multiple of the
    64-row tile and Skv not one of the key tile: within the fp32 tolerance
    of the plain version."""
    B, Sq, Skv, H, K = 2, 75, 141, 8, 2
    rng = np.random.default_rng(D + DV + causal)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device)
               for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, DV)))
    out = kernels.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.shape == (B, Sq, H, DV)
    atol, rtol = _TOL[torch.float32]
    torch.testing.assert_close(
        out, flash_attention_ref(q, k, v, causal=causal), atol=atol,
        rtol=rtol)


# ------------------------- flash attention at (qk, v) width pairs, non-causal
# (B, Sq, Skv, H, K, D, DV, causal): MLA's (192, 128) pair causal at Sq =
# Skv, Sq < Skv and Sq > Skv (dead rows), and non-causal; the encoder's
# and the cross-attention's non-causal shapes at 16/16/64 (Sq = Skv, Sq <
# Skv, Sq = 1, Sq > Skv) and a GQA one at Sq = 1
FLASH_PAIR_CASES = [
    (1, 300, 300, 16, 16, 192, 128, True),
    (1, 77, 200, 8, 8, 192, 128, True),
    (1, 96, 40, 4, 4, 192, 128, True),
    (1, 130, 130, 8, 8, 192, 128, False),
    (1, 700, 700, 16, 16, 64, 64, False),
    (1, 200, 700, 16, 16, 64, 64, False),
    (1, 1, 700, 16, 16, 64, 64, False),
    (1, 300, 90, 16, 16, 64, 64, False),
    (2, 1, 129, 32, 8, 128, 128, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_PAIR_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_width_pairs_and_non_causal_shapes(cuda_device, case,
                                                           dtype):
    """#9 with v narrower than q and k (MLA prefill) and non-causal at
    Sq != Skv and Sq = 1 (an encoder, cross-attention, a decode step's
    cross-attention) against its plain version (a bf16 output also against
    the plain fp32 version, to half an ulp); the output is (B, Sq, H, DV),
    rows that see no key are 0, and the last queries' rows are bit for bit
    the same when fewer queries tile the call differently."""
    B, Sq, Skv, H, K, D, DV, causal = case
    rng = np.random.default_rng(Sq + Skv + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device, dtype)
               for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, DV)))
    before = kernels.flash_attention.launches
    out = kernels.flash_attention(q, k, v, causal=causal, scale=0.1)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, Sq, H, DV)
    atol, rtol = _TOL[dtype]
    torch.testing.assert_close(
        out.float(),
        flash_attention_ref(q, k, v, causal=causal, scale=0.1).float(),
        atol=atol, rtol=rtol)
    ref32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                causal=causal, scale=0.1)
    atol, rtol = _TOL_BF16_VS_FP32 if dtype == torch.bfloat16 \
        else _TOL[torch.float32]
    torch.testing.assert_close(out.float(), ref32, atol=atol, rtol=rtol)
    if causal and Sq > Skv:
        assert torch.all(out[:, :Sq - Skv] == 0)
    if Sq > 1:
        tail = Sq // 2
        part = kernels.flash_attention(q[:, -tail:].contiguous(), k, v,
                                       causal=causal, scale=0.1)
        assert torch.equal(_bits(part), _bits(out[:, -tail:]))


@pytest.mark.cuda
def test_flash_kernel_refuses_a_width_pair_it_is_not_built_for(cuda_device):
    """A (qk, v) pair without an instantiation raises; no fallback."""
    q = torch.zeros((1, 4, 2, 64), device=cuda_device)
    v = torch.zeros((1, 4, 2, 32), device=cuda_device)
    with pytest.raises(ValueError, match="built for"):
        kernels.flash_attention(q, q, v)


# ------------------------------------ MLA: tensor cores, split-KV routes
def _mla_pages_per_part():
    """The pages of one MLA split-KV partition, as the built kernel has it."""
    return c_entry(ops.MLA_SOURCE, "mla_paged_attention_pages_per_part", [])()


def _mla_split_inputs(ctx, q_lens, *, H, dc, dr, T=16, L=None, seed=31):
    """A latent pool, table and queries for rows of the given contexts and
    chunk lengths; the table is one page wider than the longest row.
    Returns (q_c, q_r, pool_c, pool_kr, table, lengths, q_lens, scale)."""
    rng = np.random.default_rng(seed)
    B, Qm = len(ctx), max(max(q_lens), 1)
    lengths = np.asarray(ctx) + np.asarray(q_lens)
    MP = int(-(-lengths.max() // T)) + 1
    P = B * MP + 3
    lead = (L,) if L else ()
    f = lambda *s: torch.from_numpy(                          # noqa: E731
        rng.standard_normal(lead + s).astype(np.float32))
    table = torch.from_numpy(rng.permutation(P)[:B * MP].reshape(B, MP)
                             .astype(np.int32))
    return (f(B, Qm, H, dc), f(B, Qm, H, dr), f(P, T, dc), f(P, T, dr),
            table, torch.tensor(lengths, dtype=torch.int32),
            torch.tensor(q_lens, dtype=torch.int32),
            float(1.0 / np.sqrt(dc + dr)))


def _on(dev, pool_dtype, inputs):
    q_c, q_r, pc, pkr, *rows, scale = inputs
    return (q_c.to(dev), q_r.to(dev), pc.to(dev, pool_dtype),
            pkr.to(dev, pool_dtype), *(t.to(dev) for t in rows), scale)


def _mla_check(out, q_c, q_r, pc, pkr, tbl, lens, qls, scale):
    """Against the plain fp32 version on the same pool values, padding
    slots 0, and q_len == 1 rows bit for bit the decode entry."""
    ref = mla_paged_attention_ragged_ref(q_c, q_r, pc.float(), pkr.float(),
                                         tbl, lens, qls, scale=scale)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=4e-5)
    for b in range(q_c.shape[0]):
        assert torch.all(out[b, int(qls[b]):] == 0)
    ones = (qls == 1).nonzero().flatten()
    if len(ones):
        d1 = ops.mla_paged_attention(q_c[:, 0], q_r[:, 0], pc, pkr, tbl,
                                     lens, scale=scale)
        assert torch.equal(_bits(out[ones, 0]), _bits(d1[ones]))


# (dc, dr, H, Qmax): at H 128, dc 512 a split-route scratch holds 8 queries
_MLA_WIDTHS = [(64, 32, 16, 128), (512, 64, 128, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dc,dr,H,Qm", _MLA_WIDTHS)
def test_mla_split_route_is_the_in_block_fold(cuda_device, pool_dtype, dc,
                                              dr, H, Qm):
    """The same rows under a narrow table (the split route: scratch and a
    combine kernel) and a table wide enough that the scratch would pass
    the 128 MiB cap (the in-block fold): identical bits, and both hold
    the plain version. Rows of one to four partitions, a q_len == 1 row
    and a q_len == 0 row."""
    edge = _mla_pages_per_part() * 16
    inputs = _on(cuda_device, pool_dtype, _mla_split_inputs(
        [3 * edge + 7, edge - 9, 40, 5], [Qm, min(50, Qm - 3), 1, 0], H=H,
        dc=dc, dr=dr))
    q_c, q_r, pc, pkr, tbl, lens, qls, scale = inputs
    B, MP = tbl.shape
    width = MP
    while ops.mla_scratch_floats(1, B, Qm, H, dc, width) > 0:
        width += 64
    assert ops.mla_scratch_floats(1, B, Qm, H, dc, MP) > 0      # split
    wide = torch.cat([tbl, tbl[:, :1].repeat(1, width - MP)], dim=1)
    split = ops.mla_paged_attention_ragged(q_c, q_r, pc, pkr, tbl, lens, qls,
                                           scale=scale)
    folded = ops.mla_paged_attention_ragged(q_c, q_r, pc, pkr, wide, lens,
                                            qls, scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(_bits(split), _bits(folded))
    _mla_check(split, *inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qmax", [1, 128])
def test_mla_dead_slots_nan_inf_change_no_bit(cuda_device, pool_dtype,
                                              qmax):
    """Dead slots (past each row's length in its last page, whole pages
    past its live ones) poisoned with NaN, +inf and -inf, and stale table
    tails: no output bit moves, on either route."""
    edge = _mla_pages_per_part() * 16
    q_lens = [1, 1, 1] if qmax == 1 else [qmax, 57, 0]
    inputs = _on(cuda_device, pool_dtype, _mla_split_inputs(
        [2 * edge + 3, 70, 11], q_lens, H=128, dc=512, dr=64, seed=32))
    q_c, q_r, pc, pkr, tbl, lens, qls, scale = inputs
    out = ops.mla_paged_attention_ragged(q_c, q_r, pc, pkr, tbl, lens, qls,
                                         scale=scale)
    T = pc.shape[1]
    dead = torch.zeros(pc.shape[:2], dtype=torch.bool)
    tbl2 = tbl.clone()
    for b, n in enumerate(lens.tolist()):
        live = -(-n // T)
        if n % T:
            dead[int(tbl[b, live - 1]), n % T:] = True
        for lp in range(live, tbl.shape[1]):
            dead[int(tbl[b, lp])] = True
            tbl2[b, lp] = (-7, 10 ** 6, 3, 0)[lp % 4]    # stale tails
    for poison in (float("nan"), float("inf"), float("-inf")):
        pc2, pkr2 = pc.clone(), pkr.clone()
        pc2[dead.to(cuda_device)], pkr2[dead.to(cuda_device)] = poison, poison
        got = ops.mla_paged_attention_ragged(q_c, q_r, pc2, pkr2, tbl2, lens,
                                             qls, scale=scale)
        assert torch.equal(_bits(got), _bits(out)), poison
    _mla_check(out, *inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dc,dr", [(64, 32), (512, 64)])
@pytest.mark.parametrize("H", [128, 20])
def test_mla_row_tile_tails(cuda_device, pool_dtype, dc, dr, H):
    """Qmax * H tails: q_len 57 at Qmax 128 with H = 128, and an H that is
    no multiple of the 64-row tile (rows of two queries share a tile);
    against the plain version, padding 0, and each query of the chunk bit
    for bit the same query decoded alone at its own length."""
    inputs = _on(cuda_device, pool_dtype, _mla_split_inputs(
        [300, 90, 0], [57, 128, 3], H=H, dc=dc, dr=dr, seed=33))
    q_c, q_r, pc, pkr, tbl, lens, qls, scale = inputs
    out = ops.mla_paged_attention_ragged(q_c, q_r, pc, pkr, tbl, lens, qls,
                                         scale=scale)
    torch.cuda.synchronize()
    _mla_check(out, *inputs)
    pos0 = int(lens[0]) - int(qls[0])
    for i in (0, 29, 56):
        alone = ops.mla_paged_attention(
            q_c[:, i], q_r[:, i], pc, pkr, tbl,
            torch.full_like(lens, pos0 + i + 1), scale=scale)
        assert torch.equal(_bits(out[0, i]), _bits(alone[0])), i


_FAMILY_ENTRY = {
    ("internlm2-1.8b-smoke", "native"): "paged_attention_ragged",
    ("internlm2-1.8b-smoke", "int8"): "paged_attention_ragged_q8",
    ("deepseek-v2-236b-noexperts-smoke", "native"):
        "mla_paged_attention_ragged"}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kv_cache_dtype", sorted(_FAMILY_ENTRY))
def test_speculative_serving_on_card_matches_sequential(cuda_device, arch,
                                                        kv_cache_dtype):
    """Decode rows with 1 + 4 slots (Qmax 8) through the family's ragged
    kernel, drafts accepted and rolled back: token-identical to the
    sequential reference, one launch a layer and tick."""
    cfg = get_config(arch)
    model = LM(cfg, device=cuda_device, kv_cache_dtype=kv_cache_dtype).init(
        torch.Generator(cuda_device).manual_seed(0))
    entry = getattr(ops, _FAMILY_ENTRY[arch, kv_cache_dtype])
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (8, 12, 8)]

    def reqs():
        return [Request(rid=i, prompt=p, max_new=8)
                for i, p in enumerate(prompts)]
    ref = ServingEngine(model, ServeConfig(max_len=32, page_tokens=8),
                        device=cuda_device).generate_sequential(reqs())
    eng = ServingEngine(model, ServeConfig(
        max_len=32, page_tokens=8, speculate_k=4,
        draft_proposer=chip_smoke.ReferenceDrafts(ref, 1, cfg.vocab_size)),
        device=cuda_device)
    ops.reset_launch_counts()
    got = eng.generate(reqs())
    s = eng.stats()
    assert [r.generated for r in got] == [r.generated for r in ref]
    assert 0 < s["spec_accepted"] < s["spec_proposed"]
    assert entry.launches == cfg.num_layers * s["step_calls"]
    assert entry.launches_by_qmax.get(8, 0) > 0
    assert s["mirror_d2h_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kv_cache_dtype", sorted(_FAMILY_ENTRY))
def test_prefix_splice_and_cow_on_card(cuda_device, arch, kv_cache_dtype):
    """Three copies of a 13-token prompt and another prompt in one batch
    (8-token pages): the copies splice the first one's pages and copy the
    shared mid-page boundary page (every plane) on their first write. The
    copies' streams are one stream; dense and MLA equal the sequential
    reference (an int8 splice attends quantized K/V of the covered
    tokens, another function than one-shot prefill)."""
    cfg = get_config(arch)
    model = LM(cfg, device=cuda_device, kv_cache_dtype=kv_cache_dtype).init(
        torch.Generator(cuda_device).manual_seed(0))
    from repro_torch.core.engines import EngineSpec
    rng = np.random.default_rng(2)
    p, q = (rng.integers(0, cfg.vocab_size, 13, dtype=np.int32)
            for _ in range(2))

    def reqs():
        return [Request(rid=i, prompt=x, max_new=6)
                for i, x in enumerate((p, p, p, q))]
    eng = ServingEngine(model, ServeConfig(
        max_len=32, page_tokens=8, engine_spec=EngineSpec(
            engine="paged", prefix_cache_tokens=1024)), device=cuda_device)
    got = eng.generate(reqs())
    s = eng.stats()
    assert s["prefix_hits"] >= 2 and s["cow_copies"] >= 1
    assert got[1].generated == got[2].generated
    if kv_cache_dtype != "int8":
        ref = ServingEngine(model, ServeConfig(max_len=32, page_tokens=8),
                            device=cuda_device).generate_sequential(reqs())
        assert [r.generated for r in got] == [r.generated for r in ref]


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("engine", ["log", "kvhybrid", "paged"])
def test_mirror_serving_on_card_matches_pooled(cuda_device, engine, fuse):
    """Smoke-width dense serving through the dense mirror on the card
    (``paged`` with ``paged_decode=False``): token-identical to the pooled
    run and the sequential reference, mirror bytes moved, and no kernel
    entry launched — the mirror's step is plain torch attention."""
    from repro_torch.core.engines import EngineSpec
    cfg = get_config("internlm2-1.8b-smoke")
    model = LM(cfg, device=cuda_device).init(
        torch.Generator(cuda_device).manual_seed(0))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (8, 12, 8, 5)]

    def reqs():
        return [Request(rid=i, prompt=p, max_new=8)
                for i, p in enumerate(prompts)]
    kw = dict(max_len=32, page_tokens=8, prefill_chunk_tokens=5)
    pooled = ServingEngine(model, ServeConfig(**kw), device=cuda_device)
    want = pooled.generate(reqs())
    ref = pooled.generate_sequential(reqs())
    eng = ServingEngine(model, ServeConfig(
        engine_spec=EngineSpec(engine=engine), paged_decode=False,
        fuse_ticks=fuse, **kw), device=cuda_device)
    kernels.reset_launch_counts()
    got = eng.generate(reqs())
    torch.cuda.synchronize()
    assert not eng.pooled
    assert sum(e.launches for e in kernels.COUNTED) == 0
    assert [r.generated for r in got] == [r.generated for r in want] \
        == [r.generated for r in ref]
    assert eng.stats()["mirror_d2h_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("qmax", [chip_smoke.CHUNK, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", sorted(chip_smoke.CONFIG_GEOMS))
def test_kernel_at_config_head_shapes(cuda_device, arch, dtype, qmax):
    """The dense paged entries at the (H, K, D) of Arctic (GQA group 7),
    StarCoder2 (12), Gemma (head_dim 256) and MiniCPM (head_dim 64): the
    plain version's values, and the bitwise pins of
    ``chip_smoke.paged_pins``."""
    H, Kh, D = chip_smoke.CONFIG_GEOMS[arch]
    c = chip_smoke.dense_case(torch, cuda_device, dtype, qmax, 0,
                              geom=dict(chip_smoke.GEOM, H=H, K=Kh, D=D))
    out, ref = c.kern(*c.args), c.plain(*c.args)
    atol, rtol = _TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    c.label = f"{arch} {dtype} Qmax={qmax}"
    c.pins(out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b-smoke",
                                  "arctic-480b-smoke"])
def test_moe_block_is_deterministic_on_card(cuda_device, arch, dtype):
    """A MoE FFN over 2048 tokens at the published capacity factor (tokens
    dropped): two runs give the same bits — the combine adds each
    token's expert outputs in a fixed order, with no atomics."""
    cfg = get_config(arch)
    model = LM(cfg, dtype=dtype, device=cuda_device).init(
        torch.Generator(cuda_device).manual_seed(0))
    blk = next(b for b in model.blocks if b.ffn_kind == "moe")
    g = torch.Generator(cuda_device).manual_seed(1)
    x = torch.randn(8, 256, cfg.d_model, generator=g,
                    device=cuda_device).to(dtype)
    y1, aux1 = apply_moe(blk, cfg, x)
    y2, aux2 = apply_moe(blk, cfg, x)
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)
    assert bool(torch.isfinite(y1).all())


# ------------------------------------------- state-space families (SSM)
def _card_and_cpu_models(arch, **cut):
    """The same random weights on the CPU and on the card (fp32)."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch), **cut)
    cpu = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = LM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b-smoke", "zamba2-1.2b-smoke"])
def test_ssm_steps_on_card_match_cpu(cuda_device, arch):
    """Smoke-width Mamba-2 and Zamba2 (fp32) on the card against the same
    weights on the CPU: prefill logits and every cache key, a decode step,
    and (Mamba-2) the ragged state scan's per-slot states, within fp32
    tolerance. No kernel runs on these paths."""
    cfg, cpu, card = _card_and_cpu_models(arch)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 50)))
    kernels.reset_launch_counts()
    got = card.prefill(toks.to(cuda_device), 64)
    want = cpu.prefill(toks, 64)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
    got2 = card.decode_step(got[1], nxt.to(cuda_device), got[1]["pos"])
    want2 = cpu.decode_step(want[1], nxt, want[1]["pos"])
    atol, rtol = _TOL[torch.float32]
    for (gl, gc), (wl, wc) in ((got, want), (got2, want2)):
        torch.testing.assert_close(gl.cpu(), wl, atol=atol, rtol=rtol)
        assert set(gc) == set(wc)
        for key in wc:
            torch.testing.assert_close(gc[key].cpu(), wc[key], atol=atol,
                                       rtol=rtol)
    if cfg.family == "ssm":
        tk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 4)))
        ql, ctx = torch.tensor([4, 2]), want[1]["pos"]
        gl, gc = card.step_ragged(got[1], tk.to(cuda_device),
                                  ctx.to(cuda_device), ql.to(cuda_device))
        wl, wc = cpu.step_ragged(want[1], tk, ctx, ql)
        torch.testing.assert_close(gl.cpu(), wl, atol=atol, rtol=rtol)
        for key in ("conv_steps", "ssm_steps"):
            torch.testing.assert_close(gc[key].cpu(), wc[key], atol=atol,
                                       rtol=rtol)
    assert sum(e.launches for e in kernels.COUNTED) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch,engine,k", [
    ("mamba2-1.3b-smoke", "paged", 0), ("mamba2-1.3b-smoke", "paged", 2),
    ("mamba2-1.3b-smoke", "log", 2), ("zamba2-1.2b-smoke", "log", 0),
    ("zamba2-1.2b-smoke", "paged", 0)])
def test_ssm_serving_on_card_matches_sequential(cuda_device, arch, engine,
                                                k):
    """Smoke-width Mamba-2 (pooled state rows on ``paged``, the fused
    mirror on ``log``, with and without speculation) and Zamba2 (the
    unfused mirror) serving on the card, fp32: token-identical to the
    sequential reference, mirror-free."""
    from repro_torch.core.engines import EngineSpec
    cfg = get_config(arch)
    model = LM(cfg, device=cuda_device).init(
        torch.Generator(cuda_device).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (8, 12, 8)]

    def run(method, **kw):
        reqs = [Request(rid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        eng = ServingEngine(model, ServeConfig(
            max_len=32, page_tokens=8,
            engine_spec=EngineSpec(engine=engine), **kw), device=cuda_device)
        getattr(eng, method)(reqs)
        return [r.generated for r in reqs], eng

    ref, _ = run("generate_sequential")
    got, eng = run("generate", prefill_chunk_tokens=5, speculate_k=k)
    assert got == ref and eng.stats()["mirror_d2h_bytes"] == 0
    assert eng.pooled == (cfg.family == "ssm" and engine == "paged")
    assert eng.fused == (cfg.family == "ssm")


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1100, 600])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_zamba2_shared_attention_shape(cuda_device, dtype,
                                                       S):
    """#9 at Zamba2's shared-attention heads (H = K = 32, D = 64, MHA),
    causal, against its plain version (a bf16 output also against the
    plain fp32 version, to half an ulp)."""
    H, K, D = chip_smoke.ZAMBA2_FLASH
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device, dtype)
               for s in ((1, S, H, D), (1, S, K, D), (1, S, K, D)))
    before = kernels.flash_attention.launches
    out = kernels.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    atol, rtol = _TOL[dtype]
    torch.testing.assert_close(
        out.float(), flash_attention_ref(q, k, v, causal=True).float(),
        atol=atol, rtol=rtol)
    ref32 = flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
    atol, rtol = _TOL_BF16_VS_FP32 if dtype == torch.bfloat16 \
        else _TOL[torch.float32]
    torch.testing.assert_close(out.float(), ref32, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["paged", "log", "nvhybrid"])
def test_checkpoint_restores_card_weights_onto_the_card(cuda_device,
                                                        design):
    """Smoke-width InternLM2 in bf16 on the card: saved through
    ``CheckpointManager`` (host FS tier), crashed, restored into a model
    drawn from another seed on the card, bit for bit and on the card; the
    same CPU ``like`` restores onto the CPU."""
    from repro_torch.checkpoint import CheckpointManager
    cfg = get_config("internlm2-1.8b-smoke")
    saved = LM(cfg, dtype=torch.bfloat16, device="cuda").init(
        torch.Generator("cuda").manual_seed(0))
    mgr = CheckpointManager(design, nvmm_bytes=1 << 20)
    mgr.save(1, saved.state_dict())
    mgr.crash()
    other = LM(cfg, dtype=torch.bfloat16, device="cuda").init(
        torch.Generator("cuda").manual_seed(1))
    step, out = mgr.restore(other.state_dict())
    assert step == 1
    for k, t in saved.state_dict().items():
        assert out[k].device.type == "cuda"
        assert torch.equal(out[k].view(torch.int16), t.view(torch.int16)), k
    _, cpu = mgr.restore({k: v.cpu() for k, v in out.items()})
    assert all(v.device.type == "cpu" and torch.equal(v, out[k].cpu())
               for k, v in cpu.items())


# ------------------------------------------------ training: the Function
# (B, Sq, Skv, H, K, D, DV, causal): the dense pair at GQA group 2 and
# MLA's pair, each causal and not (an encoder's, a cross-attention's)
FUNCTION_CASES = [(2, 600, 600, 8, 4, 128, 128, True),
                  (1, 300, 700, 4, 2, 128, 128, False),
                  (1, 520, 520, 8, 8, 192, 128, True),
                  (2, 257, 257, 4, 4, 192, 128, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FUNCTION_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_gradients_on_card_are_the_plain_paths(cuda_device, case,
                                                         dtype):
    """``FlashAttentionFn`` on the card: the forward is the kernel (one
    launch, within the kernel's tolerance of the plain version) and the
    output has the Function as its ``grad_fn``; its q/k/v gradients are
    plain autograd through ``flash_attention_ref`` on the same inputs,
    within the same tolerance (the gradients' formulas are the plain
    version's; only the forward's output values differ)."""
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    B, Sq, Skv, H, K, D, DV, causal = case
    g = torch.Generator(cuda_device).manual_seed(sum(case[:7]))
    q, k, v = (torch.randn(s, generator=g, device=cuda_device).to(dtype)
               for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, DV)))
    dout = torch.randn((B, Sq, H, DV), generator=g,
                       device=cuda_device).to(dtype)
    got = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kernels.reset_launch_counts()
    out = FlashAttentionFn.apply(*got, causal, D ** -0.5)
    assert kernels.flash_attention.launches == 1
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    out.backward(dout)
    assert kernels.flash_attention.launches == 1
    want = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention_ref(*want, causal=causal, scale=D ** -0.5)
    ref.backward(dout)
    atol, rtol = _TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.grad.float(), b.grad.float(),
                                   atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_training_counts_forward_and_remat_launches(cuda_device):
    """A loss past ``chunk_size`` launches #9 once a layer, and once more a
    layer in the remat recompute; remat off, once a layer. Both give the
    same loss and gradients."""
    cfg = get_config("internlm2-1.8b-smoke")
    model = LM(cfg, device=cuda_device, chunk_size=16).init(
        torch.Generator(cuda_device).manual_seed(0))
    model.requires_grad_(True)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 41)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    runs = {}
    for remat in (True, False):
        model.remat = remat
        for p in model.parameters():
            p.grad = None
        kernels.reset_launch_counts()
        loss, _ = model.loss_fn(batch)
        loss.backward()
        torch.cuda.synchronize()
        runs[remat] = (kernels.flash_attention.launches, loss.item(),
                       {n: p.grad.clone() for n, p in
                        model.named_parameters()})
    assert runs[True][0] == 2 * cfg.num_layers
    assert runs[False][0] == cfg.num_layers
    assert runs[True][1] == runs[False][1]
    for n, gr in runs[True][2].items():
        torch.testing.assert_close(gr, runs[False][2][n], atol=1e-6,
                                   rtol=1e-5)


@pytest.mark.cuda
def test_serving_a_trainable_model_launches_as_before(cuda_device):
    """Parameters that require grad (a model being trained) change nothing
    in serving: its steps run under ``no_grad``, so long prompts prefill
    through the bare entry (no Function, no ``grad_fn``) with the launch
    counts of a frozen model, and the same tokens."""
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    cfg = get_config("internlm2-1.8b-smoke")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (20, 12, 6)]

    def run(trainable):
        model = LM(cfg, device=cuda_device, chunk_size=8).init(
            torch.Generator(cuda_device).manual_seed(0))
        model.requires_grad_(trainable)
        reqs = [Request(rid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        kernels.reset_launch_counts()
        ServingEngine(model, ServeConfig(max_len=32, page_tokens=8),
                      device=cuda_device).generate(reqs)
        counts = {e.__name__: e.launches for e in kernels.ENTRIES}
        return [r.generated for r in reqs], counts

    applied = []
    real = FlashAttentionFn.apply
    FlashAttentionFn.apply = lambda *a: applied.append(a) or real(*a)
    try:
        frozen, trained = run(False), run(True)
    finally:
        FlashAttentionFn.apply = real
    assert not applied
    assert trained == frozen
    assert frozen[1]["flash_attention"] == 2 * cfg.num_layers


def _to_card(dev, tensors):
    return [t.to(dev) for t in tensors]


@pytest.mark.cuda
@pytest.mark.parametrize("family,edge", kv_write_cases.CASES)
def test_kv_page_write_kernel_is_plain_version(cuda_device, family, edge):
    """The write kernel on the tests' cases (dense, int8 and MLA planes;
    padding rows, q_len 0, table entries of -1 and past the pool, positions
    clamped past the table): byte for byte its plain version (the
    boolean-index write) on the card and the slot-by-slot loop on the CPU,
    in one launch."""
    pools, values, table, positions, valid = kv_write_cases.case(family,
                                                                 edge)
    want = [p.clone() for p in pools]
    kv_write_cases.loop_write(want, values, table, positions, valid)
    args = _to_card(cuda_device, (table, positions, valid))
    card_values = _to_card(cuda_device, values)
    ref = _to_card(cuda_device, pools)
    kv_page_write_ref(ref, card_values, *args)
    got = _to_card(cuda_device, pools)
    ops.reset_launch_counts()
    ops.kv_page_write(got, card_values, *args)
    torch.cuda.synchronize()
    assert ops.kv_page_write.launches == 1
    for g, r, w in zip(got, ref, want):
        assert kv_write_cases.same_bytes(g.cpu(), r.cpu())
        assert kv_write_cases.same_bytes(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("kv_cache_dtype", ["native", "int8"])
def test_kv_page_write_at_the_chat_shape(cuda_device, kv_cache_dtype,
                                         offset):
    """InternLM2-1.8B's planes at a chat tick (64 rows, Qmax 128, 8 KV
    heads of 128, pages of 16) into layer 1 of a two-layer pool, values at
    an element ``offset`` from an aligned address (the kernel's narrower
    copies): byte for byte its plain version (the boolean-index write) on
    the card."""
    dev, B, Qm, K, D, T, MP = cuda_device, 64, 128, 8, 128, 16, 256
    table, positions, valid = kv_write_cases.chat_step(dev, B, Qm, T,
                                                        MP)
    g = torch.Generator(dev).manual_seed(1)
    shapes = [(K, D), (K, D)]
    dtypes = [torch.bfloat16] * 2
    if kv_cache_dtype == "int8":
        shapes += [(K,), (K,)]
        dtypes = [torch.int8] * 2 + [torch.bfloat16] * 2
    pools, values = [], []
    for shape, dt in zip(shapes, dtypes):
        planes = torch.randn((2, B * MP, T) + shape, generator=g,
                             device=dev).to(dt)
        pools.append(planes[1])
        n = B * Qm * int(np.prod(shape))
        flat = torch.randn(n + offset, generator=g, device=dev).to(dt)
        values.append(flat[offset:].view((B, Qm) + shape))
    ref = [p.clone() for p in pools]
    kv_page_write_ref(ref, values, table, positions, valid)
    before = [p.clone() for p in pools]
    ops.reset_launch_counts()
    ops.kv_page_write(pools, values, table, positions, valid)
    torch.cuda.synchronize()
    assert ops.kv_page_write.launches == 1
    assert kv_write_cases.written_slots(before, pools) \
        == int(valid.sum())
    for p, r in zip(pools, ref):
        assert kv_write_cases.same_bytes(p, r)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kv_cache_dtype", [
    ("internlm2-1.8b-smoke", "native"), ("internlm2-1.8b-smoke", "int8"),
    ("deepseek-v2-236b-noexperts-smoke", "native")])
def test_paged_steps_make_no_host_sync(cuda_device, arch, kv_cache_dtype):
    """The fused step (``step_paged_ragged``: a padding row, a decode row,
    a chunk) and the pooled decode step (``decode_step_paged``) of a small
    bf16 model, once warm, under ``torch.cuda.set_sync_debug_mode("error")``:
    no op in them waits for the card. The write launches once a layer a
    step."""
    cfg = get_config(arch)
    dev = cuda_device
    model = LM(cfg, dtype=torch.bfloat16, device=dev,
               kv_cache_dtype=kv_cache_dtype).init(
        torch.Generator(dev).manual_seed(0))
    L, P, T, MP = cfg.num_layers, 32, 8, 4
    g = torch.Generator(dev).manual_seed(1)
    cache = {"block_table": torch.randperm(P, generator=g, device=dev)[
        :3 * MP].view(3, MP).int()}
    for p in model.cache_descriptor(T).paged_planes:
        cache["pool_" + p.name] = torch.zeros(
            (L, P, T) + tuple(p.shape), dtype=p.torch_dtype, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (3, 8), generator=g,
                           device=dev)
    ctx = torch.tensor([0, 5, 9], dtype=torch.int32, device=dev)
    q_lens = torch.tensor([0, 1, 8], dtype=torch.int32, device=dev)

    def steps():
        model.step_paged_ragged(cache, tokens, ctx, q_lens)
        return model.decode_step_paged(cache, tokens[:, :1], ctx + q_lens)
    steps()                    # the kernel libraries and RoPE's table
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = steps()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert ops.kv_page_write.launches == 2 * L
    assert torch.isfinite(logits).all()
