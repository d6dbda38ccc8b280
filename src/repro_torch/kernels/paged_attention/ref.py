"""Plain PyTorch versions of the paged-attention entries.

The counterparts of the JAX package's ``paged_attention_ragged_ref``,
``paged_attention_ref``, ``paged_attention_ragged_q8_ref`` and
``mla_paged_attention_ragged_ref``: gather the pool through the clamped
block table, mask, softmax in fp32, and zero the rows the kernel contract
zeroes. The multi-layer versions (``*_layers_*``) apply the single-layer
ones layer by layer, with one block table, ``lengths`` and ``q_lens``
shared by every layer, as the JAX oracles ``vmap`` them. The CPU path of :mod:`~repro_torch.kernels.paged_attention.ops`
runs these, and the card's parity checks hold the CUDA kernels against
them.
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


def dequant_pool(pool_q, pool_scale):
    """int8 pages × per-(token, head) scales → fp32."""
    return pool_q.float() * pool_scale.float()[..., None]


def paged_attention_ragged_q8_ref(q, pool_k, pool_v, pool_ks, pool_vs,
                                  block_table, lengths, q_lens, *,
                                  scale: float | None = None):
    """Ragged attention over an int8 pool: dequantize the pages the (clamped)
    block table reaches, cast to q's dtype (as the JAX oracle does for the
    whole pool), then the dense ragged version over them. pool_k/v
    (P, T, K, D) int8; pool_ks/vs (P, T, K) bf16."""
    B, MP = block_table.shape
    table = block_table.to(q.device, torch.long).clamp(0, pool_k.shape[0] - 1)
    pk, pv = (dequant_pool(p[table], s[table]).to(q.dtype).flatten(0, 1)
              for p, s in ((pool_k, pool_ks), (pool_v, pool_vs)))
    own = torch.arange(B * MP, device=q.device).reshape(B, MP)
    return paged_attention_ragged_ref(q, pk, pv, own, lengths, q_lens,
                                      scale=scale)


def paged_attention_q8_ref(q, pool_k, pool_v, pool_ks, pool_vs, block_table,
                           lengths, *, scale: float | None = None):
    """int8 single-token decode: the ``q_len == 1`` slice of
    :func:`paged_attention_ragged_q8_ref`."""
    ones = torch.ones(q.shape[0], dtype=torch.long, device=q.device)
    return paged_attention_ragged_q8_ref(q[:, None], pool_k, pool_v, pool_ks,
                                         pool_vs, block_table, lengths, ones,
                                         scale=scale)[:, 0]


def mla_paged_attention_ragged_ref(q_c, q_r, pool_c, pool_kr, block_table,
                                   lengths, q_lens, *, scale: float):
    """Weight-absorbed MLA over the paged latent plane.

    q_c:     (B, Qmax, H, dc)  absorbed queries (q_nope · w_uk)
    q_r:     (B, Qmax, H, dr)  rope queries
    pool_c:  (P, T, dc)        latent pages (also the values)
    pool_kr: (P, T, dr)        rope-key pages
    Scores are ``(q_c·cᵀ + q_r·krᵀ) · scale``; the output is the
    probability-weighted latent (B, Qmax, H, dc) in q_c's dtype — ``w_uv``
    and ``wo`` are the model's job. Padding slots and empty rows return
    exactly zero.
    """
    B, Qm, H, dc = q_c.shape
    P = pool_c.shape[0]
    dev = q_c.device
    table = block_table.to(dev, torch.long).clamp(0, P - 1)
    lengths = lengths.to(dev, torch.long)
    q_lens = q_lens.to(dev, torch.long)
    c = pool_c[table].reshape(B, -1, dc).float()              # (B, S, dc)
    kr = pool_kr[table].reshape(B, -1, pool_kr.shape[-1]).float()
    S = c.shape[1]
    s = (torch.einsum("bqhc,btc->bhqt", q_c.float(), c)
         + torch.einsum("bqhr,btr->bhqt", q_r.float(), kr)) * scale
    ar_q = torch.arange(Qm, device=dev)
    qpos = (lengths - q_lens)[:, None] + ar_q[None, :]        # (B, Qm)
    qvalid = ar_q[None, :] < q_lens[:, None]                  # (B, Qm)
    allow = (torch.arange(S, device=dev)[None, None, :] <= qpos[:, :, None]) \
        & qvalid[:, :, None]
    s = torch.where(allow[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqt,btc->bqhc", p, c)
    keep = (qvalid & (lengths > 0)[:, None])[:, :, None, None]
    return torch.where(keep, out, 0.0).to(q_c.dtype)


def mla_paged_attention_ref(q_c, q_r, pool_c, pool_kr, block_table, lengths,
                            *, scale: float):
    """MLA single-token decode: q_c (B, H, dc), q_r (B, H, dr); the
    ``q_len == 1`` slice of :func:`mla_paged_attention_ragged_ref`."""
    ones = torch.ones(q_c.shape[0], dtype=torch.long, device=q_c.device)
    return mla_paged_attention_ragged_ref(q_c[:, None], q_r[:, None], pool_c,
                                          pool_kr, block_table, lengths, ones,
                                          scale=scale)[:, 0]


def _layers(fn, layered, *shared, **kw):
    """``fn`` on layer ``l`` of every tensor in ``layered`` (with the
    ``shared`` arguments), stacked over the layers."""
    return torch.stack([fn(*(t[i] for t in layered), *shared, **kw)
                        for i in range(layered[0].shape[0])])


def paged_attention_layers_ref(q, pool_k, pool_v, block_table, lengths, *,
                               scale: float | None = None):
    """Decode over every layer: q (L, B, H, D); pool_k/v (L, P, T, K, D).
    Returns (L, B, H, D)."""
    return _layers(paged_attention_ref, (q, pool_k, pool_v), block_table,
                   lengths, scale=scale)


def paged_attention_layers_ragged_ref(q, pool_k, pool_v, block_table,
                                      lengths, q_lens, *,
                                      scale: float | None = None):
    """Ragged attention over every layer: q (L, B, Qmax, H, D); pool_k/v
    (L, P, T, K, D). Returns (L, B, Qmax, H, D)."""
    return _layers(paged_attention_ragged_ref, (q, pool_k, pool_v),
                   block_table, lengths, q_lens, scale=scale)


def paged_attention_layers_ragged_q8_ref(q, pool_k, pool_v, pool_ks, pool_vs,
                                         block_table, lengths, q_lens, *,
                                         scale: float | None = None):
    """int8 ragged attention over every layer: q (L, B, Qmax, H, D); pools
    (L, P, T, K, D) int8 with (L, P, T, K) bf16 scales."""
    return _layers(paged_attention_ragged_q8_ref,
                   (q, pool_k, pool_v, pool_ks, pool_vs), block_table,
                   lengths, q_lens, scale=scale)


def mla_paged_attention_layers_ragged_ref(q_c, q_r, pool_c, pool_kr,
                                          block_table, lengths, q_lens, *,
                                          scale: float):
    """MLA over every layer: q_c (L, B, Qmax, H, dc); q_r (L, B, Qmax, H,
    dr); pool_c (L, P, T, dc); pool_kr (L, P, T, dr)."""
    return _layers(mla_paged_attention_ragged_ref, (q_c, q_r, pool_c, pool_kr),
                   block_table, lengths, q_lens, scale=scale)
