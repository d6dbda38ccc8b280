"""Plain PyTorch versions of the paged-attention entries.

The counterparts of the JAX package's ``paged_attention_ragged_ref`` and
``paged_attention_ref``: gather the pool through the clamped block table,
mask, softmax in fp32, and zero the rows the kernel contract zeroes. The
CPU path of :mod:`~repro_torch.kernels.paged_attention.ops` runs these,
and the card's parity checks hold the CUDA kernel against them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_ragged_ref(q, pool_k, pool_v, block_table, lengths,
                               q_lens, *, scale: float | None = None):
    """Ragged-query attention over a paged KV pool.

    q:           (B, Qmax, H, D)     up to Qmax new-token queries per row
    pool_k/v:    (P, T, K, D)        physical pages of T tokens
    block_table: (B, MaxPages) int   logical→physical page mapping (entries
                                     past a row's live pages may hold any
                                     value: they are clamped, then masked)
    lengths:     (B,) int            valid pool tokens INCLUDING the chunk
    q_lens:      (B,) int            valid queries per row (decode: 1)
    Query ``i`` of row ``b`` sits at absolute position
    ``lengths[b] - q_lens[b] + i`` and attends causally to pool positions
    at or before it. Slots at or past ``q_lens[b]`` (and whole rows with
    ``q_lens[b] == 0``) return exactly zero. Returns (B, Qmax, H, D) in
    q's dtype; the math is fp32.
    """
    B, Qm, H, D = q.shape
    P, T, K, _ = pool_k.shape
    G = H // K
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    dev = q.device
    table = block_table.to(dev, torch.long).clamp(0, P - 1)
    lengths = lengths.to(dev, torch.long)
    q_lens = q_lens.to(dev, torch.long)
    k = pool_k[table].reshape(B, -1, K, D).float()          # (B, S, K, D)
    v = pool_v[table].reshape(B, -1, K, D).float()
    S = k.shape[1]
    qg = q.reshape(B, Qm, K, G, D).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k) * scale
    ar_q = torch.arange(Qm, device=dev)
    qpos = (lengths - q_lens)[:, None] + ar_q[None, :]       # (B, Qm)
    qvalid = ar_q[None, :] < q_lens[:, None]                 # (B, Qm)
    allow = (torch.arange(S, device=dev)[None, None, :] <= qpos[:, :, None]) \
        & qvalid[:, :, None]
    s = torch.where(allow[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v)
    keep = (qvalid & (lengths > 0)[:, None])[:, :, None, None, None]
    out = torch.where(keep, out, 0.0)
    return out.reshape(B, Qm, H, D).to(q.dtype)


def paged_attention_ref(q, pool_k, pool_v, block_table, lengths, *,
                        scale: float | None = None):
    """Single-token decode over the pool: q (B, H, D). The ``q_len == 1``
    slice of :func:`paged_attention_ragged_ref`, so the two plain versions
    agree bit for bit by construction; a ``lengths == 0`` row is zero."""
    B = q.shape[0]
    ones = torch.ones(B, dtype=torch.long, device=q.device)
    return paged_attention_ragged_ref(q[:, None], pool_k, pool_v,
                                      block_table, lengths, ones,
                                      scale=scale)[:, 0]
