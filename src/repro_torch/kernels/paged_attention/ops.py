"""Public paged-attention entries: dispatch on the tensor's device.

A CUDA tensor runs the hand-written Hopper kernel of
``csrc/paged_attention.cu`` (or the call raises); a CPU tensor runs the
plain PyTorch version of :mod:`~repro_torch.kernels.paged_attention.ref`.
There is no fallback from one to the other. Each entry counts its kernel
launches in a plain integer attribute, ``<entry>.launches``.

``paged_attention_ragged`` is the fused serving tick's entry;
``paged_attention`` (single-token decode) launches the SAME kernel with
``Qmax = 1`` and ``q_lens = 1``, so at ``q_len == 1`` the two agree bit
for bit by construction.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ragged_ref, paged_attention_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)
_PAGE_TOKENS = (8, 16, 32)


def _launcher():
    lib = load_library(SOURCE)
    fn = lib.paged_attention_ragged_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, pool_k, pool_v, block_table, lengths, q_lens, scale):
    """Validate and launch the kernel on ``q``'s device and current
    stream; returns the (B, Qmax, H, D) output."""
    B, Qm, H, D = q.shape
    P, T, K, Dk = pool_k.shape
    dev = q.device
    if pool_k.device != dev or pool_v.device != dev:
        raise ValueError("q and the pool planes must be on one device")
    if q.dtype not in _DTYPE_CODE or pool_k.dtype != q.dtype \
            or pool_v.dtype != q.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q and pools "
                        f"of one dtype; got q {q.dtype}, pools "
                        f"{pool_k.dtype}/{pool_v.dtype}")
    if pool_v.shape != pool_k.shape or Dk != D or H % K:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pool_k "
                         f"{tuple(pool_k.shape)}, pool_v "
                         f"{tuple(pool_v.shape)}")
    if D not in _HEAD_DIMS or T not in _PAGE_TOKENS:
        raise ValueError(f"the kernel is built for head_dim in {_HEAD_DIMS} "
                         f"and page_tokens in {_PAGE_TOKENS}; got D={D}, "
                         f"T={T}")
    if not (pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("pool planes must be contiguous (the kernel "
                         "computes page offsets from the packed layout)")
    MP = block_table.shape[1]
    if block_table.shape[0] != B or lengths.shape != (B,) \
            or q_lens.shape != (B,):
        raise ValueError("block_table, lengths and q_lens must have one row "
                         "per batch row")
    q = q.contiguous()
    table = block_table.to(dev, torch.int32).contiguous()
    lens = lengths.to(dev, torch.int32).contiguous()
    qls = q_lens.to(dev, torch.int32).contiguous()
    out = torch.empty_like(q)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                     table.data_ptr(), lens.data_ptr(), qls.data_ptr(),
                     out.data_ptr(), B, Qm, H, K, D, P, T, MP, float(scale),
                     _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_ragged kernel launch failed: "
                           f"cudaError {rc}")
    return out


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
    if q.device.type != "cuda":
        raise ValueError(f"no paged-attention kernel for {q.device}")
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
    if q.device.type != "cuda":
        raise ValueError(f"no paged-attention kernel for {q.device}")
    ones = torch.ones(q.shape[0], dtype=torch.int32, device=q.device)
    out = _launch(q[:, None], pool_k, pool_v, block_table, lengths, ones,
                  scale)
    paged_attention.launches += 1
    return out[:, 0]


paged_attention_ragged.launches = 0
paged_attention.launches = 0


def reset_launch_counts() -> None:
    paged_attention_ragged.launches = 0
    paged_attention.launches = 0
