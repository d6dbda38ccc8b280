"""Public ``log_patch`` entry: dispatch on the tensor's device.

A CUDA tensor runs the hand-written Hopper kernel ``csrc/log_patch.cu``
(or the call raises); a CPU tensor runs the plain PyTorch version of
:mod:`~repro_torch.kernels.log_patch.ref`. There is no fallback from one
to the other. ``log_patch.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import c_entry, check_launch, require_cuda
from repro_torch.kernels.log_patch.ref import log_patch_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "log_patch.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_C, _I = ctypes.c_void_p, ctypes.c_int


def log_patch(pool, payloads, page_idx, slot_idx, valid=None):
    """Apply KV log records onto page buffers, out of place: pool (P, T,
    C), payloads (N, C), page_idx/slot_idx (N,), valid (N,) or None (all
    records valid). Records apply in log order (the later wins on a shared
    target), records with ``valid == 0`` are skipped, and indices are
    clamped into range. Returns the patched pool in pool's dtype."""
    if pool.device.type == "cpu":
        return log_patch_ref(pool, payloads, page_idx, slot_idx, valid)
    require_cuda("log-patch", pool)
    P, T, C = pool.shape
    N = payloads.shape[0]
    dev = pool.device
    if payloads.device != dev:
        raise ValueError("pool and payloads must be on one device")
    if pool.dtype not in _DTYPE_CODE or payloads.dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16 pool and "
                        f"payloads; got {pool.dtype}, {payloads.dtype}")
    if payloads.shape != (N, C) or page_idx.shape != (N,) \
            or slot_idx.shape != (N,) \
            or (valid is not None and valid.shape != (N,)):
        raise ValueError(f"shape mismatch: pool {tuple(pool.shape)}, "
                         f"payloads {tuple(payloads.shape)}, indices "
                         f"{tuple(page_idx.shape)}/{tuple(slot_idx.shape)}")
    pool, payloads = pool.contiguous(), payloads.contiguous()
    page, slot = (t.to(dev, torch.int32).contiguous()
                  for t in (page_idx, slot_idx))
    # the kernel tests valid != 0: an int32 flag tensor on the card goes
    # through as it is, any other is converted (one launch more)
    flags = None if valid is None else (
        valid if valid.dtype == torch.int32 and valid.device == dev
        else (valid.to(dev) != 0).to(torch.int32)).contiguous()
    out = torch.empty_like(pool)
    fn = c_entry(SOURCE, "log_patch_launch",
                 [_C] * 6 + [_I] * 6 + [_C])
    rc = fn(pool.data_ptr(), payloads.data_ptr(), page.data_ptr(),
            slot.data_ptr(), None if flags is None else flags.data_ptr(),
            out.data_ptr(), P, T, C, N, _DTYPE_CODE[pool.dtype],
            _DTYPE_CODE[payloads.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "log_patch")
    log_patch.launches += 1
    return out


def route(pool, payloads, out) -> str:
    """The route the kernel takes for these tensors: ``"vector"`` (16-byte
    loads and stores: a pool row a multiple of 16 bytes, all three
    pointers 16-byte aligned) or ``"scalar"``."""
    fn = c_entry(SOURCE, "log_patch_route", [_C] * 3 + [_I] * 2)
    return "vector" if fn(pool.data_ptr(), payloads.data_ptr(),
                          out.data_ptr(), pool.shape[-1],
                          _DTYPE_CODE[pool.dtype]) else "scalar"


ENTRIES = (log_patch,)


def reset_launch_counts() -> None:
    log_patch.launches = 0


reset_launch_counts()
