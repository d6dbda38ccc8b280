"""Attention over a dense cache or the paged KV pool: dense GQA, GQA over
an int8 cache, DeepSeek-V2 multi-head latent attention (MLA), and an
encoder-decoder's bidirectional and cross-attention.

The counterparts of the JAX package's ``models/attention.py`` for these
families. Prefill attention up to ``chunk_size`` tokens
(``full_attention``) is plain torch, as it is XLA code there; a longer
prefill runs the hand-written flash-attention kernel
(:mod:`~repro_torch.kernels.flash_attention`; under autograd through its
``FlashAttentionFn``, :func:`long_attention`), which computes the function
of the JAX package's ``chunked_attention``/``chunked_attention_tri`` at
positions ``arange(S)``: causal or not (an encoder, cross-attention), and
for MLA at its qk width (192) beside its v width (128). The paged steps
call the hand-written paged-attention kernels through
:mod:`~repro_torch.kernels.paged_attention.ops` (dense, int8 with
in-kernel dequant, MLA over the latent plane). The projections around the
kernels — ``w_uk`` absorption, ``w_uv``, ``wo``, the quantize-on-write
arithmetic — stay ``torch`` matmuls, as they are XLA code there.

The paged steps scatter new cache entries IN PLACE into the layer's pool
views (on the card through the hand-written write kernel, which reads
nothing back to the host): the pool tensors belong to the KV engine, which
receives the same tensors back in ``commit_step_planes``. The ragged steps
over the dense cache (``*_decode_ragged``, the dense-mirror path's fused
tick) are plain torch, as they are XLA code there, and write the dense
cache in place. Where the JAX scatter drops out-of-range writes (padding
slots aimed at page ``P`` or cache slot ``T``, ``mode="drop"``), torch
would raise — so padding slots are masked out before the scatter (or
dropped by the write kernel) and touch nothing, and block-table lookups
are clamped where JAX clamps.

On DTensors (the dry run, a mesh of real ranks) the same functions run
under ``implicit_replication``; one step differs from GSPMD: a projection
whose columns the ``model`` axis shards into pieces that split a KV head
group (InternLM2-1.8B's 8 KV heads on a 16-way axis) is all-gathered over
that axis before the head reshape (:func:`_whole_head_groups`), which
DTensor cannot unflatten unevenly; the attention then runs replicated on
that axis (ROADMAP §3).
"""
from __future__ import annotations

import math
from functools import partial

import torch

from repro_torch.distributed.sharding import (hold_layout, is_dtensor,
                                              settle_residual)
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention)
from repro_torch.kernels.paged_attention.ops import (
    kv_page_write, mla_paged_attention, mla_paged_attention_ragged,
    paged_attention, paged_attention_q8, paged_attention_ragged,
    paged_attention_ragged_q8)
from repro_torch.models.layers import apply_rope, rmsnorm

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


def _whole_head_groups(t, groups: int):
    """``t`` (..., groups · w), a projection about to be split into
    ``groups`` head groups: a DTensor whose last dim the mesh shards into
    a count of pieces that does not divide ``groups`` comes back with
    those mesh dims replicated (an all-gather); anything else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    last = Shard(t.ndim - 1)
    n = math.prod(t.device_mesh.size(i)
                  for i, pl in enumerate(t.placements) if pl == last)
    if groups % n == 0:
        return t
    return t.redistribute(t.device_mesh, [Replicate() if pl == last else pl
                                          for pl in t.placements])


def _project_qkv(p, cfg, x, positions):
    B, S, _ = x.shape
    K, H, D = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    q = _whole_head_groups(x @ p.wq, K).reshape(B, S, H, D)
    k = _whole_head_groups(x @ p.wk, K).reshape(B, S, K, D)
    v = _whole_head_groups(x @ p.wv, K).reshape(B, S, K, D)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q.reshape(B, S, K, H // K, D), k, v


def long_attention(q, k, v, *, causal, scale):
    """The attention of a sequence past ``chunk_size``: ``flash_attention``
    (the kernel on the card). With grad on and an input that requires it
    (the training path), through :class:`FlashAttentionFn`, whose output
    has a ``grad_fn`` on the card too; otherwise the entry itself, so
    serving and prefill launch exactly as without training."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, scale)
    return flash_attention(q, k, v, causal=causal, scale=scale)


def _check_rising(positions, what, chunk_size):
    """The flash kernel's causal mask is the token order: a causal prefill
    past ``chunk_size`` takes only positions that rise along S, as
    ``arange(S)`` and any offset of it do. A fake tensor (the dry run)
    has no values to check."""
    from torch._subclasses.fake_tensor import is_fake
    if is_fake(positions):
        return
    if not bool((positions.diff(dim=-1) > 0).all()):
        raise ValueError(
            f"{what} past chunk_size={chunk_size} takes positions that rise "
            f"along the sequence (the flash kernel's causal mask is the "
            f"token order)")


def attn_train(p, cfg, x, positions, *, causal=True, chunk_size=512):
    """Self-attention over a full sequence (prefill compute; ``causal``
    False for an encoder). Up to ``chunk_size`` tokens one plain einsum;
    past it the flash-attention kernel (the JAX package's chunked branches
    compute the same function). Causal, it takes only ``positions`` that
    rise along S (:func:`_check_rising`); non-causal, every query sees
    every key and positions only rotate q and k. Returns
    ``(out, (k, v))``."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if S <= chunk_size:
        out = full_attention(q, k, v, scale=scale, q_positions=positions,
                             kv_positions=positions, causal=causal)
    else:
        if causal:
            _check_rising(positions, "attn_train", chunk_size)
        out = long_attention(q.flatten(2, 3), k, v, causal=causal,
                             scale=scale)
    out = hold_layout(out.reshape(B, S, cfg.num_heads * cfg.head_dim))
    return out @ p.wo, (k, v)


def attn_cross(p, cfg, x, enc_k, enc_v, *, chunk_size=512):
    """Cross-attention of decoder ``x`` (B, S, d) over precomputed encoder
    K/V (B, T, K, D): no RoPE, no mask. ``full_attention`` while
    ``max(S, T) <= chunk_size``, the flash kernel non-causal past it (the
    JAX package's ``chunked_attention`` there). A decode step calls it
    with the default ``chunk_size`` whatever the model's, as the JAX
    decoder block does."""
    B, S, _ = x.shape
    K, H, D = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    q = _whole_head_groups(x @ p.wq, K).reshape(B, S, K, H // K, D)
    scale = 1.0 / math.sqrt(D)
    T = enc_k.shape[1]
    if max(S, T) <= chunk_size:
        pos = torch.zeros((B, S), dtype=torch.long, device=x.device)
        out = full_attention(q, enc_k, enc_v, scale=scale, q_positions=pos,
                             kv_positions=pos.new_zeros(T), causal=False)
    else:
        out = long_attention(q.flatten(2, 3), enc_k, enc_v, causal=False,
                             scale=scale)
    return hold_layout(out.reshape(B, S, H * D)) @ p.wo


def _lse_merge(s, pv, group):
    """Softmax attention over a slice of the keys, merged across the ranks
    holding the other slices (flash-decoding): ``s`` (..., T_slice) fp32
    masked scores; ``pv(e)`` the product of weights ``e`` with this
    slice's values. Returns ``(o, l)``: the sums of ``exp(s - max) · v``
    and of ``exp(s - max)`` over all slices; the attention is ``o / l``."""
    import torch.distributed._functional_collectives as funcol
    m = s.amax(dim=-1, keepdim=True)
    if group is not None:
        m = funcol.all_reduce(m, "max", group)
    e = torch.exp(s - m)
    l, o = e.sum(dim=-1, keepdim=True), pv(e)
    if group is not None:
        l = funcol.all_reduce(l, "sum", group)
        o = funcol.all_reduce(o, "sum", group)
    return o, l


def _sharded_decode(body, queries, caches, positions):
    """``body(pos, first, group, *queries, *caches)`` on each rank's shard
    of DTensor decode caches whose sequence dim the mesh slices
    (the reference's decode layout): queries and positions batch-sharded
    as the caches, ``first`` the rank's first cache position, ``group``
    the slices' group for the merge. Returns the body's output, placed as
    the queries."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import dim_shards, local_placements
    mesh, place = caches[0].device_mesh, local_placements(
        caches[0].placements, "sharded_decode")
    rows, index, group = dim_shards(caches[0], 1)

    def run(pos, *tensors):
        return body(pos, index * caches[0].to_local().shape[1], group,
                    *tensors)
    return local_map(run, out_placements=list(rows),
                     in_placements=(rows,) * (1 + len(queries))
                     + (place,) * len(caches), device_mesh=mesh,
                     redistribute_inputs=True)(positions, *queries, *caches)


def _write_rows(caches, values, positions):
    """Write ``values[j][b]`` into dense cache ``caches[j]`` (B, T, ...) at
    ``positions[b]``, IN PLACE. A DTensor cache whose sequence dim is
    sharded (the reference's decode cache layout) is written on each rank
    into its own shard: a row lands where its position falls in the
    rank's slice of T, and nowhere else."""
    if not is_dtensor(caches[0]):
        b_idx = torch.arange(positions.shape[0], device=positions.device)
        for cache, val in zip(caches, values):
            cache[b_idx, positions] = val.to(cache.dtype)
        return
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import dim_shards, local_placements
    mesh, place = caches[0].device_mesh, local_placements(
        caches[0].placements, "write_rows")
    rows, index, _ = dim_shards(caches[0], 1)

    def write(pos, *tensors):
        n = len(tensors) // 2
        local, vals = tensors[:n], tensors[n:]
        T = local[0].shape[1]
        at = pos.long() - index * T
        ok = (at >= 0) & (at < T)
        at = at.clamp(0, T - 1)
        b_idx = torch.arange(pos.shape[0], device=pos.device)
        for cache, val in zip(local, vals):
            # a row outside this slice writes back what its slot holds
            keep = ok.view((-1,) + (1,) * (val.ndim - 1))
            cache[b_idx, at] = torch.where(keep, val.to(cache.dtype),
                                           cache[b_idx, at])
    local_map(write, out_placements=None,
              in_placements=(rows,) + (place,) * len(caches)
              + (rows,) * len(values), device_mesh=mesh,
              redistribute_inputs=True)(positions, *caches, *values)


def _dense_decode_body(scale, pos, first, group, q, k, v):
    """:func:`attn_decode`'s attention on one rank's slice of the cache
    (:func:`_sharded_decode`)."""
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    kv_pos = torch.arange(k.shape[1], device=k.device) + first
    valid = kv_pos[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    o, l = _lse_merge(s, lambda e: torch.einsum("bkgst,btkd->bskgd", e,
                                                v.float()), group)
    return (o / l.permute(0, 3, 1, 2, 4)).to(q.dtype)


def _q8_decode_body(scale, pos, first, group, q, ck, cv, ck_s, cv_s):
    """:func:`attn_decode_q8`'s attention on one rank's slice of the int8
    cache, dequantized to q's dtype as the plain path reads it."""
    return _dense_decode_body(scale, pos, first, group, q,
                              dequantize_kv(ck, ck_s, q.dtype),
                              dequantize_kv(cv, cv_s, q.dtype))


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
    _write_rows((cache_k, cache_v), (k[:, 0], v[:, 0]), positions)
    if is_dtensor(cache_k):
        out = _sharded_decode(partial(_dense_decode_body, 1.0 / math.sqrt(D)),
                              (q,), (cache_k, cache_v), positions)
        return out.reshape(B, 1, H * D) @ p.wo, cache_k, cache_v
    T = cache_k.shape[1]
    kv_pos = torch.arange(T, device=x.device)
    valid = kv_pos[None, :] <= positions[:, None]
    out = full_attention(q, cache_k, cache_v, scale=1.0 / math.sqrt(D),
                         q_positions=pos2, kv_positions=kv_pos, causal=False,
                         kv_valid=valid)
    return out.reshape(B, 1, H * D) @ p.wo, cache_k, cache_v


def attn_decode_ragged(p, cfg, x, cache_k, cache_v, ctx_lens, q_lens):
    """Ragged multi-token step over the dense cache (the dense-mirror
    path's fused tick). x: (B, Qmax, d); row ``b`` appends ``q_lens[b]``
    new tokens at positions ``ctx_lens[b] + i`` (written IN PLACE into
    cache_k/v (B, T, K, D)) and each attends causally to everything at or
    before it. Padding slots write nothing; their outputs are garbage the
    caller ignores. At ``q_len == 1`` this is :func:`attn_decode` op for
    op. Returns ``(out, cache_k, cache_v)``."""
    B, Qm, _ = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    positions, valid = _ragged_positions(x, ctx_lens, q_lens)
    q, k, v = _project_qkv(p, cfg, x, positions)
    _scatter_dense((cache_k, cache_v), (k, v), positions, valid)
    kv_pos = torch.arange(cache_k.shape[1], device=x.device)
    out = full_attention(q, cache_k, cache_v, scale=1.0 / math.sqrt(D),
                         q_positions=positions, kv_positions=kv_pos,
                         causal=True)
    return out.reshape(B, Qm, H * D) @ p.wo, cache_k, cache_v


def _scatter_pool(pools, values, block_table, positions, valid):
    """Write ``values[j][b, i]`` into plane ``pools[j]`` at the page slot
    of position ``positions[b, i]``, IN PLACE, for the ``valid`` slots
    whose table entry is a real page; the others touch nothing (JAX's
    ``mode="drop"``). positions/valid: (B, Q). On the card one launch of
    the write kernel, which reads nothing back to the host
    (:func:`~repro_torch.kernels.paged_attention.ops.kv_page_write`)."""
    kv_page_write(pools, values, block_table, positions, valid)


def _ragged_positions(x, ctx_lens, q_lens):
    """(positions, valid) of a ragged step's (B, Qmax) slots."""
    ar = torch.arange(x.shape[1], device=x.device)
    return ctx_lens[:, None] + ar[None, :], ar[None, :] < q_lens[:, None]


def _scatter_dense(caches, values, positions, valid):
    """Write ``values[j][b, i]`` into dense plane ``caches[j]`` (B, T, ...)
    at ``positions[b, i]``, IN PLACE, for the ``valid`` slots inside the
    cache; the others touch nothing (JAX's ``mode="drop"``)."""
    ok = valid & (positions < caches[0].shape[1])
    b_idx = torch.arange(positions.shape[0], device=positions.device)
    b_idx = b_idx[:, None].expand_as(positions)[ok]
    pos = positions[ok]
    for cache, val in zip(caches, values):
        cache[b_idx, pos] = val[ok].to(cache.dtype)


def _decode_positions(x, positions):
    if x.shape[1] != 1:
        raise ValueError(f"a decode step takes one token per row, got "
                         f"{x.shape[1]}")
    return positions[:, None], torch.ones_like(positions[:, None],
                                               dtype=torch.bool)


def attn_decode_paged(p, cfg, x, pool_k, pool_v, block_table, positions):
    """Single-step decode directly over one layer's pool view (P, T, K, D):
    the new token's K/V goes into its page slot in place, then the decode
    kernel attends over the pool. Returns ``(out, pool_k, pool_v)``."""
    B = x.shape[0]
    H, D = cfg.num_heads, cfg.head_dim
    pos2, valid = _decode_positions(x, positions)
    q, k, v = _project_qkv(p, cfg, x, pos2)
    _scatter_pool((pool_k, pool_v), (k, v), block_table, pos2, valid)
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
    positions, valid = _ragged_positions(x, ctx_lens, q_lens)
    q, k, v = _project_qkv(p, cfg, x, positions)
    _scatter_pool((pool_k, pool_v), (k, v), block_table, positions, valid)
    out = paged_attention_ragged(
        q.reshape(B, Qm, H, D), pool_k, pool_v, block_table,
        ctx_lens + q_lens, q_lens, scale=1.0 / math.sqrt(D))
    return out.reshape(B, Qm, H * D) @ p.wo, pool_k, pool_v


# ---------------------------------------------------------------------------
# int8 KV cache: symmetric per-(token, head) scales, stored as bf16
# ---------------------------------------------------------------------------
def quantize_kv(kv):
    """kv: (..., K, D) → (int8 codes, bf16 scales (..., K)). The scale is
    ``max|x| / 127`` floored at 1e-8 (fp32); codes round half to even and
    clip to ±127."""
    x = kv.float()
    scale = (x.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.round(x / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q, scale, dtype):
    return (q.float() * scale.float()[..., None]).to(dtype)


def attn_decode_q8(p, cfg, x, ck, cv, ck_s, cv_s, positions):
    """:func:`attn_decode` over a dense int8 cache (the sequential
    reference's): quantize on write IN PLACE at ``positions``, dequantize
    the cache to the compute dtype on read. Returns
    ``(out, ck, cv, ck_s, cv_s)``."""
    B = x.shape[0]
    H, D = cfg.num_heads, cfg.head_dim
    pos2, _ = _decode_positions(x, positions)
    q, k, v = _project_qkv(p, cfg, x, pos2)
    kq, ks = quantize_kv(k[:, 0])
    vq, vs = quantize_kv(v[:, 0])
    _write_rows((ck, ck_s, cv, cv_s), (kq, ks, vq, vs), positions)
    if is_dtensor(ck):
        out = _sharded_decode(partial(_q8_decode_body, 1.0 / math.sqrt(D)),
                              (q,), (ck, cv, ck_s, cv_s), positions)
        return (out.reshape(B, 1, H * D) @ p.wo, ck, cv, ck_s, cv_s)
    kf = dequantize_kv(ck, ck_s, x.dtype)
    vf = dequantize_kv(cv, cv_s, x.dtype)
    kv_pos = torch.arange(kf.shape[1], device=x.device)
    out = full_attention(q, kf, vf, scale=1.0 / math.sqrt(D),
                         q_positions=pos2, kv_positions=kv_pos, causal=False,
                         kv_valid=kv_pos[None, :] <= positions[:, None])
    return out.reshape(B, 1, H * D) @ p.wo, ck, cv, ck_s, cv_s


def attn_decode_ragged_q8(p, cfg, x, ck, cv, ck_s, cv_s, ctx_lens, q_lens):
    """:func:`attn_decode_ragged` over a dense int8 cache: new tokens
    quantize on write (in place), padding slots write nothing, attention
    reads the dequantized cache. Returns ``(out, ck, cv, ck_s, cv_s)``."""
    B, Qm, _ = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    positions, valid = _ragged_positions(x, ctx_lens, q_lens)
    q, k, v = _project_qkv(p, cfg, x, positions)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    _scatter_dense((ck, cv, ck_s, cv_s), (kq, vq, ks, vs), positions, valid)
    kf = dequantize_kv(ck, ck_s, x.dtype)
    vf = dequantize_kv(cv, cv_s, x.dtype)
    kv_pos = torch.arange(kf.shape[1], device=x.device)
    out = full_attention(q, kf, vf, scale=1.0 / math.sqrt(D),
                         q_positions=positions, kv_positions=kv_pos,
                         causal=True)
    return out.reshape(B, Qm, H * D) @ p.wo, ck, cv, ck_s, cv_s


def attn_decode_paged_q8(p, cfg, x, pool_k, pool_v, pool_ks, pool_vs,
                         block_table, positions):
    """Single-step decode over one layer's int8 pool: the new token
    quantizes on write into its int8 page slot and scale slots (in place),
    then the int8 decode kernel dequantizes as it reads. pool_k/v
    (P, T, K, D) int8; pool_ks/vs (P, T, K) bf16. Returns
    ``(out, pool_k, pool_v, pool_ks, pool_vs)``."""
    B = x.shape[0]
    H, D = cfg.num_heads, cfg.head_dim
    pos2, valid = _decode_positions(x, positions)
    q, k, v = _project_qkv(p, cfg, x, pos2)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    pools = (pool_k, pool_v, pool_ks, pool_vs)
    _scatter_pool(pools, (kq, vq, ks, vs), block_table, pos2, valid)
    out = paged_attention_q8(q.reshape(B, H, D), *pools, block_table,
                             positions + 1, scale=1.0 / math.sqrt(D))
    return (out.reshape(B, 1, H * D) @ p.wo,) + pools


def attn_step_paged_ragged_q8(p, cfg, x, pool_k, pool_v, pool_ks, pool_vs,
                              block_table, ctx_lens, q_lens):
    """:func:`attn_step_paged_ragged` over one layer's int8 pool:
    quantize-on-write scatters into the int8 pages and scale planes, then
    one int8 ragged kernel launch. Returns
    ``(out, pool_k, pool_v, pool_ks, pool_vs)``."""
    B, Qm, _ = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    positions, valid = _ragged_positions(x, ctx_lens, q_lens)
    q, k, v = _project_qkv(p, cfg, x, positions)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    pools = (pool_k, pool_v, pool_ks, pool_vs)
    _scatter_pool(pools, (kq, vq, ks, vs), block_table, positions, valid)
    out = paged_attention_ragged_q8(
        q.reshape(B, Qm, H, D), *pools, block_table, ctx_lens + q_lens,
        q_lens, scale=1.0 / math.sqrt(D))
    return (out.reshape(B, Qm, H * D) @ p.wo,) + pools


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------
def _mla_queries(p, cfg, x, positions):
    m = cfg.mla
    B, S, _ = x.shape
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    if m.q_lora_rank:
        # on a mesh, the column-sharded latent is gathered whole before
        # its norm and the head-sharded up-projection (left to DTensor,
        # the up-projection came out Partial, and its backward sharded the
        # sequence on ``model``)
        cq = rmsnorm(p.q_norm, settle_residual(x @ p.w_dq, x), cfg.norm_eps)
        q = (cq @ p.w_uq).reshape(B, S, cfg.num_heads, qk_head)
    else:
        q = (x @ p.w_q).reshape(B, S, cfg.num_heads, qk_head)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p, cfg, x, positions):
    c_kv = rmsnorm(p.kv_norm, x @ p.w_dkv, cfg.norm_eps)
    k_rope = apply_rope((x @ p.w_kr)[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_scale(cfg):
    m = cfg.mla
    return 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def _absorb(p, q_nope):
    """q_nope · w_uk in fp32: (B, S, H, dn) → (B, S, H, dc)."""
    return torch.einsum("bshd,chd->bshc", q_nope.float(), p.w_uk.float())


def _mla_out(p, cfg, o_c, dtype):
    """Attended latent (B, S, H, dc) → ``w_uv`` → ``wo``."""
    B, S = o_c.shape[:2]
    o = torch.einsum("bshc,chd->bshd", o_c.float(),
                     p.w_uv.float()).to(dtype)
    return o.reshape(B, S, cfg.num_heads * cfg.mla.v_head_dim) @ p.wo


def mla_train(p, cfg, x, positions, *, chunk_size=512):
    """MLA over a full sequence (prefill compute), with K and V expanded
    from the latent: q and k of width qk_nope + qk_rope, v of width
    v_head. Up to ``chunk_size`` tokens one plain einsum; past it the
    flash-attention kernel at that (qk, v) width pair, causal (positions
    rising along S, :func:`_check_rising`). Returns ``(out, (c_kv,
    k_rope))`` for caching."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope = _mla_queries(p, cfg, x, positions)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    k_nope = torch.einsum("btc,chd->bthd", c_kv, p.w_uk)
    v = torch.einsum("btc,chd->bthd", c_kv, p.w_uv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    if S <= chunk_size:
        out = full_attention(q[:, :, :, None, :], k, v, scale=_mla_scale(cfg),
                             q_positions=positions, kv_positions=positions,
                             causal=True)
    else:
        _check_rising(positions, "mla_train", chunk_size)
        out = long_attention(q, k, v, causal=True, scale=_mla_scale(cfg))
    out = hold_layout(out.reshape(B, S, H * m.v_head_dim))
    return out @ p.wo, (c_kv, k_rope)


def _mla_decode_body(scale, pos, first, group, q_c, q_rope, c, kr):
    """:func:`mla_decode`'s attention on one rank's slice of the latent
    cache (:func:`_sharded_decode`)."""
    s = (torch.einsum("bshc,btc->bhst", q_c, c.float())
         + torch.einsum("bshr,btr->bhst", q_rope.float(), kr.float())) * scale
    kv_pos = torch.arange(c.shape[1], device=c.device) + first
    valid = kv_pos[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    o, l = _lse_merge(s, lambda e: torch.einsum("bhst,btc->bshc", e,
                                                c.float()), group)
    return o / l.permute(0, 2, 1, 3)


def mla_decode(p, cfg, x, cache_c, cache_kr, positions):
    """Weight-absorbed MLA decode over the dense latent cache (the
    sequential reference's): cache_c (B, T, dc), cache_kr (B, T, dr),
    written IN PLACE at ``positions``. Returns ``(out, cache_c,
    cache_kr)``."""
    pos2, _ = _decode_positions(x, positions)
    q_nope, q_rope = _mla_queries(p, cfg, x, pos2)
    c_new, kr_new = _mla_latent(p, cfg, x, pos2)
    _write_rows((cache_c, cache_kr), (c_new[:, 0], kr_new[:, 0]), positions)
    q_c = _absorb(p, q_nope)
    if is_dtensor(cache_c):
        o_c = _sharded_decode(partial(_mla_decode_body, _mla_scale(cfg)),
                              (q_c, q_rope), (cache_c, cache_kr), positions)
        return _mla_out(p, cfg, o_c, x.dtype), cache_c, cache_kr
    s = (torch.einsum("bshc,btc->bhst", q_c, cache_c.float())
         + torch.einsum("bshr,btr->bhst", q_rope.float(), cache_kr.float()))
    m = cfg.mla
    s = s / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    kv_pos = torch.arange(cache_c.shape[1], device=x.device)
    valid = kv_pos[None, :] <= positions[:, None]                  # (B, T)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    o_c = torch.einsum("bhst,btc->bshc", torch.softmax(s, dim=-1),
                       cache_c.float())
    return _mla_out(p, cfg, o_c, x.dtype), cache_c, cache_kr


def mla_decode_ragged(p, cfg, x, cache_c, cache_kr, ctx_lens, q_lens):
    """Ragged multi-token weight-absorbed MLA step over the dense latent
    cache (the dense-mirror path's fused tick for the MLA family): the
    :func:`mla_decode` einsum chain over a (B, Qmax) query block with
    causal masking inside the chunk; padding slots write nothing. Returns
    ``(out, cache_c, cache_kr)``."""
    positions, valid = _ragged_positions(x, ctx_lens, q_lens)
    q_nope, q_rope = _mla_queries(p, cfg, x, positions)
    c_new, kr_new = _mla_latent(p, cfg, x, positions)
    _scatter_dense((cache_c, cache_kr), (c_new, kr_new), positions, valid)
    q_c = _absorb(p, q_nope)
    s = (torch.einsum("bshc,btc->bhst", q_c, cache_c.float())
         + torch.einsum("bshr,btr->bhst", q_rope.float(), cache_kr.float()))
    m = cfg.mla
    s = s / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    kv_pos = torch.arange(cache_c.shape[1], device=x.device)
    allow = kv_pos[None, None, :] <= positions[:, :, None]        # (B, Q, T)
    s = torch.where(allow[:, None], s, NEG_INF)
    o_c = torch.einsum("bhst,btc->bshc", torch.softmax(s, dim=-1),
                       cache_c.float())
    return _mla_out(p, cfg, o_c, x.dtype), cache_c, cache_kr


def mla_decode_paged(p, cfg, x, pool_c, pool_kr, block_table, positions):
    """Single-step weight-absorbed MLA decode over one layer's latent pool
    (P, T, dc) / (P, T, dr): the new latent and rope key go into their page
    slots in place, then the MLA decode kernel. Returns
    ``(out, pool_c, pool_kr)``."""
    pos2, valid = _decode_positions(x, positions)
    q_nope, q_rope = _mla_queries(p, cfg, x, pos2)
    c_new, kr_new = _mla_latent(p, cfg, x, pos2)
    _scatter_pool((pool_c, pool_kr), (c_new, kr_new), block_table, pos2,
                  valid)
    o_c = mla_paged_attention(_absorb(p, q_nope)[:, 0],
                              q_rope[:, 0].float(), pool_c, pool_kr,
                              block_table, positions + 1,
                              scale=_mla_scale(cfg))
    return _mla_out(p, cfg, o_c[:, None], x.dtype), pool_c, pool_kr


def mla_step_paged_ragged(p, cfg, x, pool_c, pool_kr, block_table, ctx_lens,
                          q_lens):
    """Ragged multi-token weight-absorbed MLA step over one layer's latent
    pool — the fused tick for the MLA family, one MLA kernel launch.
    Returns ``(out, pool_c, pool_kr)``."""
    positions, valid = _ragged_positions(x, ctx_lens, q_lens)
    q_nope, q_rope = _mla_queries(p, cfg, x, positions)
    c_new, kr_new = _mla_latent(p, cfg, x, positions)
    _scatter_pool((pool_c, pool_kr), (c_new, kr_new), block_table,
                  positions, valid)
    o_c = mla_paged_attention_ragged(
        _absorb(p, q_nope), q_rope.float(), pool_c, pool_kr, block_table,
        ctx_lens + q_lens, q_lens, scale=_mla_scale(cfg))
    return _mla_out(p, cfg, o_c, x.dtype), pool_c, pool_kr
