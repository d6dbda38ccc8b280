"""Public paged-attention entries: dispatch on the tensor's device.

A CUDA tensor runs a hand-written Hopper kernel (or the call raises); a
CPU tensor runs the plain PyTorch version of
:mod:`~repro_torch.kernels.paged_attention.ref`. There is no fallback from
one to the other. Each entry counts its kernel launches in a plain
integer attribute, ``<entry>.launches``, and by the launch's Qmax in
``<entry>.launches_by_qmax`` (a dict).

* ``paged_attention_ragged`` — dense pool, ``csrc/paged_attention.cu``
  (two kernels a call: pages split across blocks in fixed partitions, then
  an ordered combine; ``launches`` counts entry calls);
* ``paged_attention_ragged_q8`` — int8 pool with bf16 scale planes, the
  same source's int8 instantiation;
* ``mla_paged_attention_ragged`` — MLA latent pool,
  ``csrc/mla_paged_attention.cu`` (a bf16 pool on the tensor cores; pages
  split across blocks in fixed partitions, folded in order either by a
  combine kernel over scratch or inside the block, as the shapes allow —
  :func:`mla_scratch_floats`).

Each single-token decode entry (``paged_attention``,
``paged_attention_q8``, ``mla_paged_attention``) launches its ragged
kernel with ``Qmax = 1`` and ``q_lens = 1``, so at ``q_len == 1`` the two
agree bit for bit by construction. The multi-layer entries
(``paged_attention_layers``, ``paged_attention_layers_ragged``,
``paged_attention_layers_ragged_q8``, ``mla_paged_attention_layers_ragged``)
take every layer's queries and ``(L, P, T, ...)`` pool planes at once, with
one block table, ``lengths`` and ``q_lens`` for all layers, and launch the
same kernels once with a layer axis in the grid; a single-layer entry is
that launch at ``L = 1``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import c_entry, check_launch, require_cuda
from repro_torch.kernels.paged_attention.ref import (
    mla_paged_attention_layers_ragged_ref, mla_paged_attention_ragged_ref,
    mla_paged_attention_ref, paged_attention_layers_ragged_q8_ref,
    paged_attention_layers_ragged_ref, paged_attention_layers_ref,
    paged_attention_q8_ref, paged_attention_ragged_q8_ref,
    paged_attention_ragged_ref, paged_attention_ref)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "paged_attention.cu"
MLA_SOURCE = CSRC / "mla_paged_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)
_LATENT_DIMS = (32, 64, 128, 256, 512)
_ROPE_DIMS = (16, 32, 64)
_PAGE_TOKENS = (8, 16, 32)
_C = ctypes.c_void_p


def _fn(source, name, n_ptrs, n_ints):
    """The C entry ``name`` of ``source``: ``n_ptrs`` pointers, ``n_ints``
    ints, the scale, a dtype code and the stream."""
    return c_entry(source, name, [_C] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float, ctypes.c_int, _C])


def _same_device(dev, *ts):
    if any(t.device != dev for t in ts):
        raise ValueError("queries and pool planes must be on one device")


def _contiguous(*ts):
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("pool planes must be contiguous (the kernel "
                         "computes page offsets from the packed layout)")


def _row_args(B, dev, block_table, lengths, q_lens):
    """The table, lengths and q_lens as contiguous int32 on ``dev``."""
    if block_table.shape[0] != B or lengths.shape != (B,) \
            or q_lens.shape != (B,):
        raise ValueError("block_table, lengths and q_lens must have one row "
                         "per batch row")
    return tuple(t.to(dev, torch.int32).contiguous()
                 for t in (block_table, lengths, q_lens))


@functools.lru_cache(maxsize=256)
def scratch_floats(L, B, Qm, H, K, D, MP):
    """fp32 elements of split-KV scratch a launch of these shapes takes (at
    least 1; capped in ``csrc/paged_attention.cu``, which runs the launch
    in passes past the cap)."""
    return max(c_entry(SOURCE, "paged_attention_scratch_floats",
                       [ctypes.c_int] * 7, ctypes.c_int64)(L, B, Qm, H, K, D,
                                                           MP), 1)


@functools.lru_cache(maxsize=256)
def mla_scratch_floats(L, B, Qm, H, dc, MP):
    """fp32 elements of split-KV scratch an MLA launch of these shapes
    takes: 0 when the launch folds its partitions inside the block (one
    partition, or scratch past the 128 MiB cap), else the split route's
    (m, l, acc) of every (layer, b, row, partition). Shapes only."""
    return c_entry(MLA_SOURCE, "mla_paged_attention_scratch_floats",
                   [ctypes.c_int] * 6, ctypes.c_int64)(L, B, Qm, H, dc, MP)


def _launch(q, pool_k, pool_v, block_table, lengths, q_lens, scale,
            scales=None):
    """Validate and launch the dense (``scales is None``) or int8 kernel
    over every layer on ``q``'s device and current stream: q (L, B, Qmax,
    H, D), pools (L, P, T, K, D), scales (L, P, T, K). Returns the
    (L, B, Qmax, H, D) output in q's dtype."""
    L, B, Qm, H, D = q.shape
    _, P, T, K, Dk = pool_k.shape
    dev = q.device
    planes = (pool_k, pool_v) + (scales or ())
    _same_device(dev, *planes)
    kv_dtype = torch.int8 if scales else q.dtype
    if q.dtype not in _DTYPE_CODE or pool_k.dtype != kv_dtype \
            or pool_v.dtype != kv_dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q and "
                        f"{'int8' if scales else 'same-dtype'} pools; got q "
                        f"{q.dtype}, pools {pool_k.dtype}/{pool_v.dtype}")
    if pool_v.shape != pool_k.shape or pool_k.shape[0] != L or Dk != D \
            or H % K:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pool_k "
                         f"{tuple(pool_k.shape)}, pool_v "
                         f"{tuple(pool_v.shape)}")
    if scales and any(s.dtype != torch.bfloat16 or s.shape != (L, P, T, K)
                      for s in scales):
        raise ValueError(f"scale planes must be bfloat16 of shape "
                         f"{(L, P, T, K)}")
    if D not in _HEAD_DIMS or T not in _PAGE_TOKENS:
        raise ValueError(f"the kernel is built for head_dim in {_HEAD_DIMS} "
                         f"and page_tokens in {_PAGE_TOKENS}; got D={D}, "
                         f"T={T}")
    _contiguous(*planes)
    table, lens, qls = _row_args(B, dev, block_table, lengths, q_lens)
    q = q.contiguous()
    out = torch.empty_like(q)
    MP = table.shape[1]
    # the split-KV partitions' (m, l, acc), combined by the second kernel
    scratch = torch.empty(scratch_floats(L, B, Qm, H, K, D, MP),
                          dtype=torch.float32, device=dev)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    dims = (L, B, Qm, H, K, D, P, T, MP, float(scale), _DTYPE_CODE[q.dtype],
            stream)
    if scales:
        rc = _fn(SOURCE, "paged_attention_layers_ragged_q8_launch", 10, 9)(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            scales[0].data_ptr(), scales[1].data_ptr(), table.data_ptr(),
            lens.data_ptr(), qls.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), *dims)
    else:
        rc = _fn(SOURCE, "paged_attention_layers_ragged_launch", 8, 9)(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            table.data_ptr(), lens.data_ptr(), qls.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), *dims)
    check_launch(rc, "paged_attention_ragged" + ("_q8" if scales else ""))
    return out


def _launch_mla(q_c, q_r, pool_c, pool_kr, block_table, lengths, q_lens,
                scale):
    """Validate and launch the MLA kernel over every layer: q_c (L, B,
    Qmax, H, dc), q_r (L, B, Qmax, H, dr), pool_c (L, P, T, dc), pool_kr
    (L, P, T, dr). Returns (L, B, Qmax, H, dc) fp32."""
    L, B, Qm, H, dc = q_c.shape
    dr = q_r.shape[-1]
    _, P, T, dc_p = pool_c.shape
    dev = q_c.device
    _same_device(dev, q_r, pool_c, pool_kr)
    if q_c.dtype != torch.float32 or q_r.dtype != torch.float32 \
            or pool_c.dtype not in _DTYPE_CODE \
            or pool_kr.dtype != pool_c.dtype:
        raise TypeError(f"the MLA kernel takes float32 queries and float32 "
                        f"or bfloat16 pools of one dtype; got q_c "
                        f"{q_c.dtype}, q_r {q_r.dtype}, pools "
                        f"{pool_c.dtype}/{pool_kr.dtype}")
    if q_r.shape != (L, B, Qm, H, dr) or pool_c.shape[0] != L \
            or dc_p != dc or pool_kr.shape != (L, P, T, dr):
        raise ValueError(f"shape mismatch: q_c {tuple(q_c.shape)}, q_r "
                         f"{tuple(q_r.shape)}, pool_c {tuple(pool_c.shape)},"
                         f" pool_kr {tuple(pool_kr.shape)}")
    if dc not in _LATENT_DIMS or dr not in _ROPE_DIMS \
            or T not in _PAGE_TOKENS:
        raise ValueError(f"the MLA kernel is built for kv_lora_rank in "
                         f"{_LATENT_DIMS}, qk_rope_head_dim in {_ROPE_DIMS} "
                         f"and page_tokens in {_PAGE_TOKENS}; got dc={dc}, "
                         f"dr={dr}, T={T}")
    _contiguous(pool_c, pool_kr)
    table, lens, qls = _row_args(B, dev, block_table, lengths, q_lens)
    q_c, q_r = q_c.contiguous(), q_r.contiguous()
    out = torch.empty_like(q_c)
    MP = table.shape[1]
    # the split route's partition states, folded by the combine kernel
    scratch = torch.empty(max(mla_scratch_floats(L, B, Qm, H, dc, MP), 1),
                          dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn(MLA_SOURCE, "mla_paged_attention_layers_ragged_launch", 9, 9)(
        q_c.data_ptr(), q_r.data_ptr(), pool_c.data_ptr(),
        pool_kr.data_ptr(), table.data_ptr(), lens.data_ptr(),
        qls.data_ptr(), out.data_ptr(), scratch.data_ptr(), L, B, Qm, H, dc,
        dr, P, T, MP, float(scale), _DTYPE_CODE[pool_c.dtype], stream)
    check_launch(rc, "mla_paged_attention_ragged")
    return out


def _ones(q):
    return torch.ones(q.shape[-3], dtype=torch.int32, device=q.device)


def _one(*ts):
    """Single-layer tensors as a one-layer stack (views, no copy)."""
    return tuple(t[None] for t in ts)


# ------------------------------------------------------------ dense pool
def paged_attention_ragged(q, pool_k, pool_v, block_table, lengths, q_lens,
                           *, scale: float | None = None):
    """Ragged-query attention over a paged KV pool.

    q: (B, Qmax, H, D); pool_k/v: (P, T, K, D); block_table: (B, MP);
    lengths: (B,) valid pool tokens including the chunk; q_lens: (B,)
    valid queries per row. Padding query slots and ``q_lens == 0`` rows
    return exactly zero. Returns (B, Qmax, H, D) in q's dtype.
    """
    if q.device.type == "cpu":
        return paged_attention_ragged_ref(q, pool_k, pool_v, block_table,
                                          lengths, q_lens, scale=scale)
    require_cuda("paged-attention", q)
    out = _launch(*_one(q, pool_k, pool_v), block_table, lengths, q_lens,
                  scale)[0]
    _count(paged_attention_ragged, q.shape[1])
    return out


def paged_attention(q, pool_k, pool_v, block_table, lengths, *,
                    scale: float | None = None):
    """Single-token decode over a paged KV pool: q (B, H, D); a
    ``lengths == 0`` row returns zero. The ragged kernel at Qmax = 1."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, pool_k, pool_v, block_table, lengths,
                                   scale=scale)
    require_cuda("paged-attention", q)
    out = _launch(*_one(q[:, None], pool_k, pool_v), block_table, lengths,
                  _ones(q), scale)[0]
    _count(paged_attention, 1)
    return out[:, 0]


def paged_attention_layers_ragged(q, pool_k, pool_v, block_table, lengths,
                                  q_lens, *, scale: float | None = None):
    """Ragged-query attention over every layer in one launch: q (L, B,
    Qmax, H, D); pool_k/v (L, P, T, K, D); one block_table (B, MP),
    lengths and q_lens (B,) for all layers. Layer ``l`` of the output is
    :func:`paged_attention_ragged` on layer ``l`` bit for bit."""
    if q.device.type == "cpu":
        return paged_attention_layers_ragged_ref(
            q, pool_k, pool_v, block_table, lengths, q_lens, scale=scale)
    require_cuda("paged-attention", q)
    out = _launch(q, pool_k, pool_v, block_table, lengths, q_lens, scale)
    _count(paged_attention_layers_ragged, q.shape[2])
    return out


def paged_attention_layers(q, pool_k, pool_v, block_table, lengths, *,
                           scale: float | None = None):
    """Single-token decode over every layer in one launch: q (L, B, H, D);
    pool_k/v (L, P, T, K, D). The multi-layer ragged kernel at Qmax = 1,
    so :func:`paged_attention_layers_ragged` at ``q_len == 1`` equals it
    bit for bit."""
    if q.device.type == "cpu":
        return paged_attention_layers_ref(q, pool_k, pool_v, block_table,
                                          lengths, scale=scale)
    require_cuda("paged-attention", q)
    out = _launch(q[:, :, None], pool_k, pool_v, block_table, lengths,
                  _ones(q), scale)
    _count(paged_attention_layers, 1)
    return out[:, :, 0]


# ------------------------------------------------------------- int8 pool
def paged_attention_ragged_q8(q, pool_k, pool_v, pool_ks, pool_vs,
                              block_table, lengths, q_lens, *,
                              scale: float | None = None):
    """Ragged-query attention over an int8 KV pool: pool_k/v (P, T, K, D)
    int8, pool_ks/vs (P, T, K) bf16 per-(token, head) scales, dequantized
    in the kernel. Otherwise as :func:`paged_attention_ragged`."""
    if q.device.type == "cpu":
        return paged_attention_ragged_q8_ref(q, pool_k, pool_v, pool_ks,
                                             pool_vs, block_table, lengths,
                                             q_lens, scale=scale)
    require_cuda("paged-attention", q)
    q, pool_k, pool_v, pool_ks, pool_vs = _one(q, pool_k, pool_v, pool_ks,
                                               pool_vs)
    out = _launch(q, pool_k, pool_v, block_table, lengths, q_lens, scale,
                  scales=(pool_ks, pool_vs))[0]
    _count(paged_attention_ragged_q8, q.shape[2])   # q: (1, B, Qmax, H, D)
    return out


def paged_attention_q8(q, pool_k, pool_v, pool_ks, pool_vs, block_table,
                       lengths, *, scale: float | None = None):
    """Single-token decode over an int8 KV pool: q (B, H, D). The int8
    ragged kernel at Qmax = 1."""
    if q.device.type == "cpu":
        return paged_attention_q8_ref(q, pool_k, pool_v, pool_ks, pool_vs,
                                      block_table, lengths, scale=scale)
    require_cuda("paged-attention", q)
    q1, pool_k, pool_v, pool_ks, pool_vs = _one(q[:, None], pool_k, pool_v,
                                                pool_ks, pool_vs)
    out = _launch(q1, pool_k, pool_v, block_table, lengths, _ones(q), scale,
                  scales=(pool_ks, pool_vs))[0]
    _count(paged_attention_q8, 1)
    return out[:, 0]


def paged_attention_layers_ragged_q8(q, pool_k, pool_v, pool_ks, pool_vs,
                                     block_table, lengths, q_lens, *,
                                     scale: float | None = None):
    """int8 ragged attention over every layer in one launch: q (L, B,
    Qmax, H, D); pool_k/v (L, P, T, K, D) int8; pool_ks/vs (L, P, T, K)
    bf16. Layer ``l`` is :func:`paged_attention_ragged_q8` on layer ``l``
    bit for bit."""
    if q.device.type == "cpu":
        return paged_attention_layers_ragged_q8_ref(
            q, pool_k, pool_v, pool_ks, pool_vs, block_table, lengths,
            q_lens, scale=scale)
    require_cuda("paged-attention", q)
    out = _launch(q, pool_k, pool_v, block_table, lengths, q_lens, scale,
                  scales=(pool_ks, pool_vs))
    _count(paged_attention_layers_ragged_q8, q.shape[2])
    return out


# -------------------------------------------------------------- MLA pool
def mla_paged_attention_ragged(q_c, q_r, pool_c, pool_kr, block_table,
                               lengths, q_lens, *, scale: float):
    """Weight-absorbed MLA over the paged latent pool. q_c: (B, Qmax, H,
    dc) fp32; q_r: (B, Qmax, H, dr) fp32; pool_c (P, T, dc) and pool_kr
    (P, T, dr) in the compute dtype. Returns the attended latent
    (B, Qmax, H, dc) fp32; padding slots and empty rows are zero."""
    if q_c.device.type == "cpu":
        return mla_paged_attention_ragged_ref(q_c, q_r, pool_c, pool_kr,
                                              block_table, lengths, q_lens,
                                              scale=scale)
    require_cuda("MLA paged-attention", q_c)
    out = _launch_mla(*_one(q_c, q_r, pool_c, pool_kr), block_table, lengths,
                      q_lens, scale)[0]
    _count(mla_paged_attention_ragged, q_c.shape[1])
    return out


def mla_paged_attention(q_c, q_r, pool_c, pool_kr, block_table, lengths, *,
                        scale: float):
    """MLA single-token decode: q_c (B, H, dc), q_r (B, H, dr). The MLA
    ragged kernel at Qmax = 1."""
    if q_c.device.type == "cpu":
        return mla_paged_attention_ref(q_c, q_r, pool_c, pool_kr,
                                       block_table, lengths, scale=scale)
    require_cuda("MLA paged-attention", q_c)
    out = _launch_mla(*_one(q_c[:, None], q_r[:, None], pool_c, pool_kr),
                      block_table, lengths, _ones(q_c), scale)[0]
    _count(mla_paged_attention, 1)
    return out[:, 0]


def mla_paged_attention_layers_ragged(q_c, q_r, pool_c, pool_kr, block_table,
                                      lengths, q_lens, *, scale: float):
    """MLA over every layer in one launch: q_c (L, B, Qmax, H, dc); q_r
    (L, B, Qmax, H, dr); pool_c (L, P, T, dc); pool_kr (L, P, T, dr).
    Layer ``l`` is :func:`mla_paged_attention_ragged` on layer ``l`` bit
    for bit."""
    if q_c.device.type == "cpu":
        return mla_paged_attention_layers_ragged_ref(
            q_c, q_r, pool_c, pool_kr, block_table, lengths, q_lens,
            scale=scale)
    require_cuda("MLA paged-attention", q_c)
    out = _launch_mla(q_c, q_r, pool_c, pool_kr, block_table, lengths,
                      q_lens, scale)
    _count(mla_paged_attention_layers_ragged, q_c.shape[2])
    return out


ENTRIES = (paged_attention_ragged, paged_attention, paged_attention_ragged_q8,
           paged_attention_q8, mla_paged_attention_ragged,
           mla_paged_attention, paged_attention_layers,
           paged_attention_layers_ragged, paged_attention_layers_ragged_q8,
           mla_paged_attention_layers_ragged)


def _count(entry, qmax: int) -> None:
    """One launch of ``entry``'s kernel, in total and at its Qmax."""
    entry.launches += 1
    entry.launches_by_qmax[qmax] = entry.launches_by_qmax.get(qmax, 0) + 1


def reset_launch_counts() -> None:
    for entry in ENTRIES:
        entry.launches = 0
        entry.launches_by_qmax = {}


reset_launch_counts()
