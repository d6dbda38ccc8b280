"""Public paged-attention entries: dispatch on the tensor's device.

A CUDA tensor runs a hand-written Hopper kernel (or the call raises); a
CPU tensor runs the plain PyTorch version of
:mod:`~repro_torch.kernels.paged_attention.ref`. There is no fallback from
one to the other. Each entry counts its kernel launches in a plain
integer attribute, ``<entry>.launches``.

* ``paged_attention_ragged`` — dense pool, ``csrc/paged_attention.cu``;
* ``paged_attention_ragged_q8`` — int8 pool with bf16 scale planes, the
  same source's int8 instantiation;
* ``mla_paged_attention_ragged`` — MLA latent pool,
  ``csrc/mla_paged_attention.cu``.

Each single-token decode entry (``paged_attention``,
``paged_attention_q8``, ``mla_paged_attention``) launches its ragged
kernel with ``Qmax = 1`` and ``q_lens = 1``, so at ``q_len == 1`` the two
agree bit for bit by construction.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.paged_attention.ref import (
    mla_paged_attention_ragged_ref, mla_paged_attention_ref,
    paged_attention_q8_ref, paged_attention_ragged_q8_ref,
    paged_attention_ragged_ref, paged_attention_ref)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "paged_attention.cu"
MLA_SOURCE = CSRC / "mla_paged_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)
_LATENT_DIMS = (32, 64, 128, 256, 512)
_PAGE_TOKENS = (8, 16, 32)
_C = ctypes.c_void_p


def _fn(source, name, n_ptrs, n_ints):
    """The C entry ``name`` of ``source``'s library with its argtypes:
    ``n_ptrs`` pointers, ``n_ints`` ints, the scale, a dtype code and the
    stream."""
    fn = getattr(load_library(source), name)
    if fn.argtypes is None:
        fn.argtypes = ([_C] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float, ctypes.c_int, _C])
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(entry, t):
    if t.device.type != "cuda":
        raise ValueError(f"no {entry} kernel for {t.device}")


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


def _raise_on(rc, entry):
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")


def _launch(q, pool_k, pool_v, block_table, lengths, q_lens, scale,
            scales=None):
    """Validate and launch the dense (``scales is None``) or int8 kernel
    on ``q``'s device and current stream; returns the (B, Qmax, H, D)
    output in q's dtype."""
    B, Qm, H, D = q.shape
    P, T, K, Dk = pool_k.shape
    dev = q.device
    planes = (pool_k, pool_v) + (scales or ())
    _same_device(dev, *planes)
    kv_dtype = torch.int8 if scales else q.dtype
    if q.dtype not in _DTYPE_CODE or pool_k.dtype != kv_dtype \
            or pool_v.dtype != kv_dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q and "
                        f"{'int8' if scales else 'same-dtype'} pools; got q "
                        f"{q.dtype}, pools {pool_k.dtype}/{pool_v.dtype}")
    if pool_v.shape != pool_k.shape or Dk != D or H % K:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pool_k "
                         f"{tuple(pool_k.shape)}, pool_v "
                         f"{tuple(pool_v.shape)}")
    if scales and any(s.dtype != torch.bfloat16 or s.shape != (P, T, K)
                      for s in scales):
        raise ValueError(f"scale planes must be bfloat16 of shape "
                         f"{(P, T, K)}")
    if D not in _HEAD_DIMS or T not in _PAGE_TOKENS:
        raise ValueError(f"the kernel is built for head_dim in {_HEAD_DIMS} "
                         f"and page_tokens in {_PAGE_TOKENS}; got D={D}, "
                         f"T={T}")
    _contiguous(*planes)
    table, lens, qls = _row_args(B, dev, block_table, lengths, q_lens)
    q = q.contiguous()
    out = torch.empty_like(q)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    dims = (B, Qm, H, K, D, P, T, table.shape[1], float(scale),
            _DTYPE_CODE[q.dtype], stream)
    if scales:
        rc = _fn(SOURCE, "paged_attention_ragged_q8_launch", 9, 8)(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            scales[0].data_ptr(), scales[1].data_ptr(), table.data_ptr(),
            lens.data_ptr(), qls.data_ptr(), out.data_ptr(), *dims)
    else:
        rc = _fn(SOURCE, "paged_attention_ragged_launch", 7, 8)(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            table.data_ptr(), lens.data_ptr(), qls.data_ptr(),
            out.data_ptr(), *dims)
    _raise_on(rc, "paged_attention_ragged" + ("_q8" if scales else ""))
    return out


def _launch_mla(q_c, q_r, pool_c, pool_kr, block_table, lengths, q_lens,
                scale):
    """Validate and launch the MLA kernel; returns (B, Qmax, H, dc) fp32."""
    B, Qm, H, dc = q_c.shape
    dr = q_r.shape[-1]
    P, T, dc_p = pool_c.shape
    dev = q_c.device
    _same_device(dev, q_r, pool_c, pool_kr)
    if q_c.dtype != torch.float32 or q_r.dtype != torch.float32 \
            or pool_c.dtype not in _DTYPE_CODE \
            or pool_kr.dtype != pool_c.dtype:
        raise TypeError(f"the MLA kernel takes float32 queries and float32 "
                        f"or bfloat16 pools of one dtype; got q_c "
                        f"{q_c.dtype}, q_r {q_r.dtype}, pools "
                        f"{pool_c.dtype}/{pool_kr.dtype}")
    if q_r.shape != (B, Qm, H, dr) or dc_p != dc \
            or pool_kr.shape != (P, T, dr):
        raise ValueError(f"shape mismatch: q_c {tuple(q_c.shape)}, q_r "
                         f"{tuple(q_r.shape)}, pool_c {tuple(pool_c.shape)},"
                         f" pool_kr {tuple(pool_kr.shape)}")
    if dc not in _LATENT_DIMS or T not in _PAGE_TOKENS:
        raise ValueError(f"the MLA kernel is built for kv_lora_rank in "
                         f"{_LATENT_DIMS} and page_tokens in {_PAGE_TOKENS};"
                         f" got dc={dc}, T={T}")
    _contiguous(pool_c, pool_kr)
    table, lens, qls = _row_args(B, dev, block_table, lengths, q_lens)
    q_c, q_r = q_c.contiguous(), q_r.contiguous()
    out = torch.empty_like(q_c)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn(MLA_SOURCE, "mla_paged_attention_ragged_launch", 8, 8)(
        q_c.data_ptr(), q_r.data_ptr(), pool_c.data_ptr(),
        pool_kr.data_ptr(), table.data_ptr(), lens.data_ptr(),
        qls.data_ptr(), out.data_ptr(), B, Qm, H, dc, dr, P, T,
        table.shape[1], float(scale), _DTYPE_CODE[pool_c.dtype], stream)
    _raise_on(rc, "mla_paged_attention_ragged")
    return out


def _ones(q):
    return torch.ones(q.shape[0], dtype=torch.int32, device=q.device)


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
    _check_cuda("paged-attention", q)
    out = _launch(q, pool_k, pool_v, block_table, lengths, q_lens, scale)
    paged_attention_ragged.launches += 1
    return out


def paged_attention(q, pool_k, pool_v, block_table, lengths, *,
                    scale: float | None = None):
    """Single-token decode over a paged KV pool: q (B, H, D); a
    ``lengths == 0`` row returns zero. The ragged kernel at Qmax = 1."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, pool_k, pool_v, block_table, lengths,
                                   scale=scale)
    _check_cuda("paged-attention", q)
    out = _launch(q[:, None], pool_k, pool_v, block_table, lengths, _ones(q),
                  scale)
    paged_attention.launches += 1
    return out[:, 0]


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
    _check_cuda("paged-attention", q)
    out = _launch(q, pool_k, pool_v, block_table, lengths, q_lens, scale,
                  scales=(pool_ks, pool_vs))
    paged_attention_ragged_q8.launches += 1
    return out


def paged_attention_q8(q, pool_k, pool_v, pool_ks, pool_vs, block_table,
                       lengths, *, scale: float | None = None):
    """Single-token decode over an int8 KV pool: q (B, H, D). The int8
    ragged kernel at Qmax = 1."""
    if q.device.type == "cpu":
        return paged_attention_q8_ref(q, pool_k, pool_v, pool_ks, pool_vs,
                                      block_table, lengths, scale=scale)
    _check_cuda("paged-attention", q)
    out = _launch(q[:, None], pool_k, pool_v, block_table, lengths, _ones(q),
                  scale, scales=(pool_ks, pool_vs))
    paged_attention_q8.launches += 1
    return out[:, 0]


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
    _check_cuda("MLA paged-attention", q_c)
    out = _launch_mla(q_c, q_r, pool_c, pool_kr, block_table, lengths,
                      q_lens, scale)
    mla_paged_attention_ragged.launches += 1
    return out


def mla_paged_attention(q_c, q_r, pool_c, pool_kr, block_table, lengths, *,
                        scale: float):
    """MLA single-token decode: q_c (B, H, dc), q_r (B, H, dr). The MLA
    ragged kernel at Qmax = 1."""
    if q_c.device.type == "cpu":
        return mla_paged_attention_ref(q_c, q_r, pool_c, pool_kr,
                                       block_table, lengths, scale=scale)
    _check_cuda("MLA paged-attention", q_c)
    out = _launch_mla(q_c[:, None], q_r[:, None], pool_c, pool_kr,
                      block_table, lengths, _ones(q_c), scale)
    mla_paged_attention.launches += 1
    return out[:, 0]


ENTRIES = (paged_attention_ragged, paged_attention, paged_attention_ragged_q8,
           paged_attention_q8, mla_paged_attention_ragged,
           mla_paged_attention)


def reset_launch_counts() -> None:
    for entry in ENTRIES:
        entry.launches = 0


reset_launch_counts()
