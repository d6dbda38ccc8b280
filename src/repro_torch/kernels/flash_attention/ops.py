"""Public ``flash_attention`` entry: dispatch on the tensor's device.

A CUDA tensor runs the hand-written Hopper kernel ``csrc/flash_attention.cu``
(or the call raises); a CPU tensor runs the plain PyTorch version of
:mod:`~repro_torch.kernels.flash_attention.ref`. There is no fallback from
one to the other. ``flash_attention.launches`` counts kernel launches.

:class:`FlashAttentionFn` puts the entry under autograd for the training
path: its forward is :func:`flash_attention` (the kernel on the card: no
``grad_fn`` comes out of a ctypes launch on its own), its backward the
plain version's gradient (``ref.flash_attention_ref_backward``, plain
PyTorch: the JAX package has no backward kernel either). The forward
never falls back to the plain version when the kernel cannot build or
launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import c_entry, check_launch, require_cuda
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_ref, flash_attention_ref_backward)

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the (qk, v) head widths the kernel is built for: the four equal pairs,
# and MLA's (qk_nope + qk_rope, v_head) at DeepSeek-V2's widths
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128))
_C, _I = ctypes.c_void_p, ctypes.c_int


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, block_q: int = 128,
                    block_k: int = 128):
    """Flash attention, forward: q (B, Sq, H, D), k (B, Skv, K, D) and v
    (B, Skv, K, DV) with H = K * G; query head ``h`` reads KV head
    ``h // G``. The output is (B, Sq, H, DV): DV is D, or MLA's v width
    beside its qk width (``HEAD_DIMS`` lists the pairs the kernel is built
    for). Causal queries are the last Sq positions of the Skv keys; a
    query that sees no key (Sq > Skv) returns 0. ``scale`` defaults to
    1/sqrt(D). The math is fp32; q, k and v are fp32 or bf16 of one dtype
    and the output has q's. ``block_q``/``block_k`` are the TPU kernel's
    block sizes: the CUDA kernel tiles on its own, and no block size
    changes a bit of the result."""
    if block_q <= 0 or block_k <= 0:
        raise ValueError(f"block sizes must be positive, got {block_q}, "
                         f"{block_k}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    require_cuda("flash-attention", q)
    B, Sq, H, D = q.shape
    Bk, Skv, K, Dk = k.shape
    DV = v.shape[-1]
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q, k, v of "
                        f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if v.ndim != 4 or v.shape[:3] != k.shape[:3] or Bk != B or Dk != D \
            or K == 0 or H % K:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if (D, DV) not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for (qk, v) head widths in "
                         f"{HEAD_DIMS}; got ({D}, {DV})")
    # the kernel stages q, k and v with 16-byte cp.async: a contiguous
    # view at an unaligned offset is copied (rows are D or DV elements,
    # multiples of 32, so an aligned base aligns every row)
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
               for t in (q.contiguous(), k.contiguous(),
                         v.contiguous()))
    out = q.new_empty((B, Sq, H, DV))
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    fn = c_entry(SOURCE, "flash_attention_launch",
                 [_C] * 4 + [_I] * 8 + [ctypes.c_float, _I, _C])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, K, D, DV, int(bool(causal)), float(scale),
            _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(rc, "flash_attention")
    flash_attention.launches += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient: ``FlashAttentionFn.apply(q, k,
    v, causal, scale)``. The forward launches the kernel (counted in
    ``flash_attention.launches``) on a CUDA tensor, runs the plain version
    on a CPU one; the backward recomputes the plain version's gradient
    from the saved q, k and v. Under activation checkpointing the forward
    runs again in the recompute, and launches again."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale):
        out = flash_attention(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_ref_backward(
            q, k, v, dout.contiguous(), causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


ENTRIES = (flash_attention,)


def reset_launch_counts() -> None:
    flash_attention.launches = 0


reset_launch_counts()
