"""The port on the card: the hand-written CUDA kernel against its plain
PyTorch version, and the pooled serving path through it.

Every test here is marked ``cuda`` and skips when torch sees no GPU (the
decision is taken inside the ``cuda_device`` fixture, never at import).
The file imports only torch, numpy and the port, so it runs on a machine
without JAX: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ragged_ref
from repro_torch.models import LM
from repro_torch.serving import Request, ServeConfig, ServingEngine

# tests/test_kernels.py: atol 5·_RTOL, rtol 2·_RTOL
_TOL = {torch.float32: (1e-4, 4e-5), torch.bfloat16: (1e-1, 4e-2)}


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
