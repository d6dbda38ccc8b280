"""Public ``flash_attention`` entry: dispatch on the tensor's device.

A CUDA tensor runs the hand-written Hopper kernel ``csrc/flash_attention.cu``
(or the call raises); a CPU tensor runs the plain PyTorch version of
:mod:`~repro_torch.kernels.flash_attention.ref`. There is no fallback from
one to the other. ``flash_attention.launches`` counts kernel launches.

The entry goes through a ``torch.library`` custom op,
``repro_torch::flash_attention`` (the kernel launch or the plain version
inside), so that what does not run a real tensor can still see it: its
fake implementation gives the output's shape and dtype (the dry run on
``FakeTensorMode``), a flop formula is registered with
``torch.utils.flop_counter`` (:func:`flash_flops`: the (query, key) pairs
a row sees, as ``chip_smoke.py`` counts #9's bound). On DTensors the
entry runs the op on each rank's shard (``local_map``): batch (dim 0)
sharded where q's is, heads (dim 2) where q's are and the mesh dim
divides the KV heads, else replicated; sequence and head width are never
sharded. The placement is the port's, not left to DTensor's strategy
choice, which differs between torch releases.

:class:`FlashAttentionFn` puts the entry under autograd for the training
path: its forward is :func:`flash_attention` (the kernel on the card: no
``grad_fn`` comes out of a ctypes launch on its own), its backward the
plain version's gradient (``ref.flash_attention_ref_backward``, plain
PyTorch: the JAX package has no backward kernel either); on DTensors the
backward runs that same function on each rank's shard
(``local_map``), placed as the forward. The
forward never falls back to the plain version when the kernel cannot
build or launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.distributed.sharding import is_dtensor, local_placements
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
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    op = torch.ops.repro_torch.flash_attention
    if is_dtensor(q):
        from torch.distributed.tensor.experimental import local_map
        place = _local_placements(q, k)
        return local_map(lambda *qkv: op(*qkv, bool(causal), float(scale)),
                         out_placements=list(place),
                         in_placements=(place,) * 3,
                         device_mesh=q.device_mesh,
                         redistribute_inputs=True)(q, k, v)
    return op(q, k, v, bool(causal), float(scale))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        # contiguous, as the kernel's output is (the same values)
        return flash_attention_ref(q, k, v, causal=causal,
                                   scale=scale).contiguous()
    return _launch(q, k, v, causal, scale)


@_flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, scale):
    return q.new_empty(q.shape[:3] + v.shape[-1:])


def _launch(q, k, v, causal: bool, scale: float):
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
    fn = c_entry(SOURCE, "flash_attention_launch",
                 [_C] * 4 + [_I] * 8 + [ctypes.c_float, _I, _C])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, K, D, DV, int(bool(causal)), float(scale),
            _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(rc, "flash_attention")
    flash_attention.launches += 1
    return out


def causal_pairs(Sq: int, Skv: int, causal: bool) -> int:
    """The (query, key) pairs the attention computes: every pair
    non-causal; causal, query ``i`` (position ``i + Skv - Sq``) sees the
    keys at or before it."""
    if not causal:
        return Sq * Skv
    # query i sees i + Skv - Sq + 1 keys (never more than Skv): none
    # before query Sq - Skv, then one more each
    lo = max(0, Sq - Skv)
    n, first = Sq - lo, lo + Skv - Sq + 1
    return n * first + n * (n - 1) // 2


def flash_flops(q_shape, k_shape, v_shape, causal: bool) -> int:
    """Operations of one call: ``2 (D + DV)`` a (query, key) pair and query
    head (the score's product and the value's), over the pairs the call
    computes (:func:`causal_pairs`) — the work ``chip_smoke.py`` bounds #9
    by."""
    B, Sq, H, D = q_shape
    return 2 * (D + v_shape[-1]) * H * B * causal_pairs(Sq, k_shape[1],
                                                         causal)


def _register_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _flops(q_shape, k_shape, v_shape, causal, scale, *args,
               out_shape=None, **kwargs):
        return flash_flops(q_shape, k_shape, v_shape, causal)


_register_formulas()


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
        fn = flash_attention_ref_backward
        if is_dtensor(q):
            fn = _local_backward(q, k)
        dq, dk, dv = fn(q, k, v, dout.contiguous(), causal=ctx.causal,
                        scale=ctx.scale)
        return dq, dk, dv, None, None


def _local_placements(q, k) -> tuple:
    """Where each rank runs #9 on DTensor inputs: per mesh dim, batch
    sharded where q's batch is, heads where q's heads are and the dim
    divides the KV heads, else replicated; sequence and head width never
    sharded."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    return tuple(
        p if p == Shard(0) or (p == Shard(2)
                               and k.shape[2] % mesh.size(i) == 0)
        else Replicate()
        for i, p in enumerate(local_placements(q.placements, "flash")))


def _local_backward(q, k):
    """``flash_attention_ref_backward`` on each rank's shard of DTensor
    inputs, placed as the forward (:func:`_local_placements`); the
    gradients come back placed alike."""
    from functools import partial

    from torch.distributed.tensor.experimental import local_map
    mesh, place = q.device_mesh, _local_placements(q, k)

    def run(q, k, v, dout, *, causal, scale):
        return local_map(partial(flash_attention_ref_backward,
                                 causal=causal, scale=scale),
                         out_placements=(place,) * 3,
                         in_placements=(place,) * 4, device_mesh=mesh,
                         redistribute_inputs=True)(q, k, v, dout)
    return run


ENTRIES = (flash_attention,)


def reset_launch_counts() -> None:
    flash_attention.launches = 0


reset_launch_counts()
