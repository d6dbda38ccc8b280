"""Plain PyTorch version of ``log_patch``.

Replays log records onto a page pool in log order, the later record
winning on a shared target, with the Pallas kernel's index rule: page and
slot indices are clamped into range (the JAX package's jnp oracle drops
out-of-range records instead; ROADMAP.md, section 3). The CPU path of
:mod:`~repro_torch.kernels.log_patch.ops` runs this, and the card's parity
checks hold the CUDA kernel against it.
"""
from __future__ import annotations

import torch


def log_patch_ref(pool, payloads, page_idx, slot_idx, valid=None):
    """pool (P, T, C); payloads (N, C); page_idx/slot_idx (N,) int;
    valid (N,) (nonzero = apply) or None (all). Returns the patched pool, a
    new tensor in pool's dtype."""
    P, T, C = pool.shape
    N = payloads.shape[0]
    dev = pool.device
    page = page_idx.to(dev, torch.long).clamp(0, P - 1)
    slot = slot_idx.to(dev, torch.long).clamp(0, T - 1)
    keep = (torch.ones(N, dtype=torch.bool, device=dev) if valid is None
            else valid.to(dev) != 0)
    # the last valid record of each target wins: keep only those, so the
    # scatter below writes every target once
    target = page * T + slot
    order = torch.arange(N, device=dev)
    last = torch.full((P * T,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, target[keep], order[keep], reduce="amax")
    win = keep & (last[target] == order)
    out = pool.clone()
    out.view(P * T, C)[target[win]] = payloads[win].to(pool.dtype)
    return out
