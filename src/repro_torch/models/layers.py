"""Shared primitive layers: norms, RoPE, FFNs, embeddings, inits.

Plain functions on tensors, the counterparts of the JAX package's
``models/layers.py``. Weight matrices keep its ``(d_in, d_out)`` layout
(``x @ W``), so the same numbers give the same products. Matmuls run in the
tensors' dtype (the model's compute dtype); norm, RoPE and softmax
statistics run in fp32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def truncated_normal_(t: torch.Tensor, scale: float, generator,
                      fan_in: int | None = None) -> None:
    """Fill ``t`` in place the way the JAX package initializes weights:
    ``std = scale / sqrt(fan_in)`` (by default the first axis of a
    matrix), normal truncated at two standard deviations. The fp32 draw
    buffer is as large as ``t``: fill a stack of matrices one at a time."""
    if fan_in is None:
        fan_in = t.shape[0] if t.ndim > 1 else 1
    std = scale / float(np.sqrt(fan_in))
    with torch.no_grad():
        buf = torch.empty(t.shape, dtype=torch.float32, device=t.device)
        torch.nn.init.trunc_normal_(buf, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=generator)
        t.copy_(buf)


def rmsnorm(scale, x, eps):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``(head_dim / 2,)`` fp32 inverse frequencies, computed in numpy
    float32 exactly as the JAX package computes them."""
    exponents = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    return torch.from_numpy(1.0 / (theta ** exponents)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split RoPE in fp32. x: (..., seq, heads, head_dim); positions
    broadcastable to (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)        # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                       # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _act(name, x):
    if name == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")       # geglu and gelu


def ffn_matrices(d: int, f: int, activation: str) -> dict:
    """A dense FFN's matrix name → shape: gated for ``swiglu``/``geglu``,
    two matrices otherwise."""
    out = {"w_gate": (d, f)} if activation in ("swiglu", "geglu") else {}
    out.update({"w_up": (d, f), "w_down": (f, d)})
    return out


def apply_ffn(p, x, activation):
    """Dense FFN; ``p`` carries ``w_up``/``w_down`` and, gated, ``w_gate``."""
    if getattr(p, "w_gate", None) is not None:
        h = _act(activation, x @ p.w_gate) * (x @ p.w_up)
    else:
        h = _act(activation, x @ p.w_up)
    return h @ p.w_down


def embed(table, tokens, scale=1.0):
    out = table[tokens]
    if scale != 1.0:
        out = out * torch.tensor(scale, dtype=out.dtype)
    return out


def lm_logits(table, h, logit_scale=1.0, soft_cap=0.0,
              vocab_size: int | None = None):
    """fp32 logits over the (possibly padded) vocab; padded columns are
    masked to -1e30 so softmax/argmax ignore them."""
    logits = (h @ table.T).float()
    if logit_scale != 1.0:
        logits = logits * logit_scale
    if soft_cap > 0.0:
        logits = soft_cap * torch.tanh(logits / soft_cap)
    if vocab_size is not None and vocab_size < table.shape[0]:
        pad_mask = torch.arange(table.shape[0], device=h.device) < vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    return logits
