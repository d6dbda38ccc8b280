"""Ragged-batch bookkeeping for continuous-batching decode.

The counterparts of the JAX package's ``serving/batching.py`` helpers.
Per-sequence caches are *rows* whose arrays keep their batch dimension at
size 1. The batch axis differs per cache key:

* ``pos`` — ``(B,)``: axis 0;
* ``seg_conv``/``seg_ssm`` (the Zamba2 hybrid) — ``(n_seg, seg_len, B,
  ...)``, and ``conv_steps``/``ssm_steps`` (the ragged SSM step's
  per-slot states, ``(L, slots, B, ...)``): axis 2;
* every other plane (``k``/``v``, the int8 scales, MLA's ``c``/``kr``,
  SSM ``conv``/``ssm``, the hybrid's ``shared_k``/``shared_v`` and
  ``tail_*``) — ``(L, B, ...)``: axis 1.

On the dense-mirror path a row holds its whole padded cache on the
device: :func:`concat_rows` copies rows into one batch for a step (so a
step's in-place writes never reach the rows it was built from, padding
rows included), :func:`split_row` hands back views into that batch, and
the gathers slice each tick's new tokens on device so only they cross
the device→host link, as float16. On the pooled path a row is just
``{"pos"}`` — its KV lives in the engine's device page pool — and the
scatter/gather helpers move prompt KV between the dense prefill cache and
the pool entirely on device. Host round-trips are exact copies.
"""
from __future__ import annotations

import torch

_SPECIAL_BATCH_AXIS = {"pos": 0, "seg_conv": 2, "seg_ssm": 2,
                       "conv_steps": 2, "ssm_steps": 2}


def batch_axis(key: str) -> int:
    """The batch dimension of cache entry ``key``."""
    return _SPECIAL_BATCH_AXIS.get(key, 1)


def concat_rows(rows: list[dict]) -> dict:
    """Concatenate per-sequence cache rows (batch dim 1 each) into one
    batched cache, preserving row order."""
    return {k: torch.cat([r[k] for r in rows], dim=batch_axis(k))
            for k in rows[0]}


def split_row(cache: dict, i: int) -> dict:
    """Slice row ``i`` back out of a batched cache (keeps batch dim 1)."""
    return {k: v.narrow(batch_axis(k), i, 1) for k, v in cache.items()}


def row_to_host(row: dict) -> dict:
    """Copy a cache row to host memory (preemption spill)."""
    return {k: v.to("cpu", copy=True) for k, v in row.items()}


def row_to_device(row: dict, device) -> dict:
    """Bring a spilled cache row back onto ``device`` (restore)."""
    return {k: torch.as_tensor(v).to(device) for k, v in row.items()}


def bucket_pow2(n: int) -> int:
    """Smallest power of two ≥ n — the step-shape ladder (pad + mask).
    Padding rows carry ``q_len = 0`` and are masked end to end."""
    return 1 << max(int(n) - 1, 0).bit_length()


def gather_new_kv(cache_k, cache_v, positions):
    """On-device gather of the tokens a decode step just wrote.
    cache_k/cache_v: (L, B, T, K, D); positions: (B,). Returns
    (B, L, 2, K, D) float16, still on device."""
    positions = positions.to(cache_k.device, torch.long)
    b_idx = torch.arange(positions.shape[0], device=cache_k.device)
    k = cache_k[:, b_idx, positions]          # (L, B, K, D)
    v = cache_v[:, b_idx, positions]
    return torch.stack([k, v], dim=2).permute(1, 0, 2, 3, 4).to(
        torch.float16)


def gather_new_kv_ragged(cache_k, cache_v, ctx_lens, qmax: int):
    """On-device gather of the tokens a fused ragged step just wrote.
    cache_k/cache_v: (L, B, T, K, D); row ``b``'s new tokens sit at
    ``ctx_lens[b] + i`` for ``i < qmax`` (slots past the row's ``q_len``
    hold padding, clamped to ``T - 1``, that the caller slices off).
    Returns (B, qmax, L, 2, K, D) float16, still on device."""
    ctx_lens = ctx_lens.to(cache_k.device, torch.long)
    B = ctx_lens.shape[0]
    pos = ctx_lens[:, None] + torch.arange(qmax, device=cache_k.device)
    pos = pos.clamp_max(cache_k.shape[2] - 1)
    b_idx = torch.arange(B, device=cache_k.device)[:, None]
    k = cache_k[:, b_idx, pos]                # (L, B, qmax, K, D)
    v = cache_v[:, b_idx, pos]
    return torch.stack([k, v], dim=2).permute(1, 3, 0, 2, 4, 5).to(
        torch.float16)


def gather_prefill_kv(cache_k, cache_v, n: int):
    """On-device slice of a batch-1 prompt's prefilled KV: (L, 2, n, K, D)
    float16, cast before transfer (the mirror's dtype)."""
    return torch.stack([cache_k[:, 0, :n], cache_v[:, 0, :n]],
                       dim=1).to(torch.float16)


def gather_kv_range(cache_k, cache_v, lo: int, hi: int):
    """On-device slice of cache positions ``[lo, hi)`` of a batch-1 row:
    (L, 2, hi - lo, K, D) float16 — one transfer for a chunk the unfused
    mirror path ran token by token."""
    return torch.stack([cache_k[:, 0, lo:hi], cache_v[:, 0, lo:hi]],
                       dim=1).to(torch.float16)


def scatter_prefill_planes(pools, caches, phys, n: int):
    """Scatter a batch-1 prompt's prefilled cache planes into its pool
    pages on device, IN PLACE (a device-to-device copy, zero bytes over
    the device→host link).

    pools: one ``(L, P, T, *shape)`` tensor per descriptor plane; caches:
    the matching prefill planes ``(L, 1, max_len, *shape)``; phys:
    ``(npages,)`` physical pages owning logical pages ``0..npages-1``.
    Slots past ``n`` in the last page carry prefill padding — readers mask
    them with ``lengths`` and later appends overwrite them. Returns
    ``pools``."""
    phys = torch.as_tensor(phys, dtype=torch.long, device=pools[0].device)
    npages = phys.shape[0]
    for pool, cache in zip(pools, caches):
        L, _, T = pool.shape[:3]
        c = cache[:, 0, :npages * T].reshape((L, npages, T) + pool.shape[3:])
        pool[:, phys] = c.to(pool.dtype)
    return tuple(pools)


def copy_pool_page_planes(pools, src: int, dst: int):
    """Duplicate one physical page group on device across every plane, IN
    PLACE (prefix-sharing copy-on-write: the writer takes the copy at
    ``dst``, readers keep ``src``). One device read + write of a page
    group, zero host traffic. Returns ``pools``."""
    for p in pools:
        p[:, dst].copy_(p[:, src])
    return tuple(pools)
