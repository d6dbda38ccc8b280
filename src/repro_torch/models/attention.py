"""Dense GQA attention over a dense cache or the paged KV pool.

The counterparts of the dense-GQA functions of the JAX package's
``models/attention.py``. Prefill attention (``full_attention``) is plain
torch, as it is XLA code there; the paged steps call the hand-written
paged-attention kernel through
:mod:`~repro_torch.kernels.paged_attention.ops`.

The paged steps scatter new K/V IN PLACE into the layer's pool view: the
pool tensors belong to the KV engine, which receives the same tensors back
in ``commit_step_planes``. Where the JAX scatter drops out-of-range writes
(padding slots aimed at page ``P``, ``mode="drop"``), torch would raise —
so padding slots are masked out before the scatter and never touch the
pool, and block-table lookups are clamped where JAX clamps.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_attention_ragged)
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def full_attention(q, k, v, *, scale, q_positions, kv_positions, causal,
                   kv_valid=None):
    """Single-einsum attention. q: (B, S, K, G, D); k/v: (B, T, K, D);
    q_positions (B, S); kv_positions (T,) or (B, T); kv_valid (B, T)."""
    B, S, K, G, D = q.shape
    T = k.shape[1]
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    if kv_positions.ndim == 1:
        kv_positions = kv_positions[None, :].expand(B, T)
    allow = torch.ones((B, S, T), dtype=torch.bool, device=q.device)
    if causal:
        allow = kv_positions[:, None, :] <= q_positions[:, :, None]
    if kv_valid is not None:
        allow = allow & kv_valid[:, None, :]
    s = torch.where(allow[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.to(q.dtype)


def _project_qkv(p, cfg, x, positions):
    B, S, _ = x.shape
    K, H, D = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    q = (x @ p.wq).reshape(B, S, H, D)
    k = (x @ p.wk).reshape(B, S, K, D)
    v = (x @ p.wv).reshape(B, S, K, D)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q.reshape(B, S, K, H // K, D), k, v


def attn_train(p, cfg, x, positions, *, chunk_size=512):
    """Causal self-attention over a full sequence (prefill compute).
    Returns ``(out, (k, v))``."""
    B, S, _ = x.shape
    if S > chunk_size:
        raise NotImplementedError(
            f"prompt of {S} tokens > chunk_size={chunk_size}: chunked "
            f"prefill attention is not ported yet (ROADMAP.md, modules to "
            f"port, item 3); split the prompt with prefill_chunk_tokens")
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = full_attention(q, k, v, scale=1.0 / math.sqrt(cfg.head_dim),
                         q_positions=positions, kv_positions=positions,
                         causal=True)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return out @ p.wo, (k, v)


def attn_decode(p, cfg, x, cache_k, cache_v, positions):
    """Single-step decode over a dense cache. cache_k/v: (B, T, K, D),
    written IN PLACE at ``positions`` (B,), which is also the query
    position. Returns ``(out, cache_k, cache_v)``."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"attn_decode takes one token per row, got {S}")
    H, D = cfg.num_heads, cfg.head_dim
    pos2 = positions[:, None]
    q, k, v = _project_qkv(p, cfg, x, pos2)
    b_idx = torch.arange(B, device=x.device)
    cache_k[b_idx, positions] = k[:, 0].to(cache_k.dtype)
    cache_v[b_idx, positions] = v[:, 0].to(cache_v.dtype)
    T = cache_k.shape[1]
    kv_pos = torch.arange(T, device=x.device)
    valid = kv_pos[None, :] <= positions[:, None]
    out = full_attention(q, cache_k, cache_v, scale=1.0 / math.sqrt(D),
                         q_positions=pos2, kv_positions=kv_pos, causal=False,
                         kv_valid=valid)
    return out.reshape(B, 1, H * D) @ p.wo, cache_k, cache_v


def attn_decode_paged(p, cfg, x, pool_k, pool_v, block_table, positions):
    """Single-step decode directly over one layer's pool view (P, T, K, D):
    the new token's K/V goes into its page slot in place, then the decode
    kernel attends over the pool. Returns ``(out, pool_k, pool_v)``."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"attn_decode_paged takes one token per row, "
                         f"got {S}")
    H, D = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv(p, cfg, x, positions[:, None])
    P, T = pool_k.shape[0], pool_k.shape[1]
    b_idx = torch.arange(B, device=x.device)
    logical = (positions // T).clamp(0, block_table.shape[1] - 1)
    phys = block_table[b_idx, logical].long()
    ok = (phys >= 0) & (phys < P)          # JAX drops out-of-range writes
    slot = positions % T
    pool_k[phys[ok], slot[ok]] = k[:, 0][ok].to(pool_k.dtype)
    pool_v[phys[ok], slot[ok]] = v[:, 0][ok].to(pool_v.dtype)
    out = paged_attention(q.reshape(B, H, D), pool_k, pool_v, block_table,
                          positions + 1, scale=1.0 / math.sqrt(D))
    return out.reshape(B, 1, H * D) @ p.wo, pool_k, pool_v


def attn_step_paged_ragged(p, cfg, x, pool_k, pool_v, block_table,
                           ctx_lens, q_lens):
    """Ragged multi-token step over one layer's pool view — the fused
    tick's attention: decode rows (``q_len == 1``) and prefill-chunk rows
    share one kernel launch. x: (B, Qmax, d_model); ctx_lens (B,) tokens
    already pooled; q_lens (B,) new tokens per row (0 = padding row). Valid
    slots scatter their K/V in place; padding slots touch nothing.
    Returns ``(out, pool_k, pool_v)``."""
    B, Qm, _ = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    ar = torch.arange(Qm, device=x.device)
    positions = ctx_lens[:, None] + ar[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    P, T = pool_k.shape[0], pool_k.shape[1]
    logical = (positions // T).clamp(0, block_table.shape[1] - 1)
    phys = torch.gather(block_table, 1, logical).long()        # (B, Qm)
    ok = (ar[None, :] < q_lens[:, None]) & (phys >= 0) & (phys < P)
    slot = positions % T
    pool_k[phys[ok], slot[ok]] = k[ok].to(pool_k.dtype)
    pool_v[phys[ok], slot[ok]] = v[ok].to(pool_v.dtype)
    out = paged_attention_ragged(
        q.reshape(B, Qm, H, D), pool_k, pool_v, block_table,
        ctx_lens + q_lens, q_lens, scale=1.0 / math.sqrt(D))
    return out.reshape(B, Qm, H * D) @ p.wo, pool_k, pool_v
