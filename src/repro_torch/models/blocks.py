"""Decoder block: parameters as an ``nn.Module``, math as functions.

The counterparts of the dense decoder-block functions of the JAX
package's ``models/blocks.py``: pre-norm GQA attention and a dense
(Swi)GLU FFN, each added back through ``residual_scale``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import apply_ffn, rmsnorm, truncated_normal_

#: block parameter names → (shape from cfg, JAX pytree path)
_MATRICES = {
    "wq": (lambda c: (c.d_model, c.num_heads * c.head_dim), ("attn", "wq")),
    "wk": (lambda c: (c.d_model, c.num_kv_heads * c.head_dim), ("attn", "wk")),
    "wv": (lambda c: (c.d_model, c.num_kv_heads * c.head_dim), ("attn", "wv")),
    "wo": (lambda c: (c.num_heads * c.head_dim, c.d_model), ("attn", "wo")),
    "w_gate": (lambda c: (c.d_model, c.d_ff), ("ffn", "w_gate")),
    "w_up": (lambda c: (c.d_model, c.d_ff), ("ffn", "w_up")),
    "w_down": (lambda c: (c.d_ff, c.d_model), ("ffn", "w_down")),
}
_NORMS = {"ln_attn": ("ln_attn", "scale"), "ln_ffn": ("ln_ffn", "scale")}


def frozen_param(shape, dtype, device, fill=None):
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class DecoderBlock(nn.Module):
    """One dense decoder layer's parameters, stored in the compute dtype."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        if cfg.ffn_activation not in ("swiglu", "geglu"):
            raise NotImplementedError(
                f"ungated FFN ({cfg.ffn_activation!r}) is not ported yet")
        for name in _NORMS:
            setattr(self, name, frozen_param((cfg.d_model,), dtype, device,
                                             1.0))
        for name, (shape, _) in _MATRICES.items():
            setattr(self, name, frozen_param(shape(cfg), dtype, device))

    def init_weights(self, generator) -> None:
        """The JAX package's init distributions: truncated normal with
        ``std = 1/sqrt(fan_in)``, norm scales at 1."""
        for name in _NORMS:
            getattr(self, name).data.fill_(1.0)
        for name in _MATRICES:
            truncated_normal_(getattr(self, name), 1.0, generator)


def _ffn(p, cfg, h):
    x = rmsnorm(p.ln_ffn, h, cfg.norm_eps)
    return h + cfg.residual_scale * apply_ffn(p, x, cfg.ffn_activation)


def apply_decoder_block(p, cfg, h, positions, *, chunk_size: int = 512):
    """Full-sequence block (prefill). Returns ``(h, (k, v))``."""
    x = rmsnorm(p.ln_attn, h, cfg.norm_eps)
    a, kv = attn_mod.attn_train(p, cfg, x, positions, chunk_size=chunk_size)
    return _ffn(p, cfg, h + cfg.residual_scale * a), kv


def decode_decoder_block(p, cfg, h, cache, positions):
    """Single-token block over one layer's dense cache ``(k, v)``."""
    x = rmsnorm(p.ln_attn, h, cfg.norm_eps)
    a, c0, c1 = attn_mod.attn_decode(p, cfg, x, cache[0], cache[1],
                                     positions)
    return _ffn(p, cfg, h + cfg.residual_scale * a), (c0, c1)


def decode_paged_block(p, cfg, h, planes, block_table, positions):
    """Single-token block over one layer's pool planes ``(k, v)``."""
    x = rmsnorm(p.ln_attn, h, cfg.norm_eps)
    a, *planes = attn_mod.attn_decode_paged(p, cfg, x, planes[0], planes[1],
                                            block_table, positions)
    return _ffn(p, cfg, h + cfg.residual_scale * a), tuple(planes)


def step_paged_ragged_block(p, cfg, h, planes, block_table, ctx_lens,
                            q_lens):
    """Ragged multi-token block over one layer's pool planes ``(k, v)``
    (the fused mixed-batch tick)."""
    x = rmsnorm(p.ln_attn, h, cfg.norm_eps)
    a, *planes = attn_mod.attn_step_paged_ragged(
        p, cfg, x, planes[0], planes[1], block_table, ctx_lens, q_lens)
    return _ffn(p, cfg, h + cfg.residual_scale * a), tuple(planes)


def jax_block_arrays(np_blocks: dict, i: int) -> dict:
    """Layer ``i`` of the JAX package's stacked ``params["blocks"]`` pytree
    (leading L axis) as ``{port name: numpy array}``."""
    out = {}
    for name, (_, path) in _MATRICES.items():
        out[name] = np_blocks[path[0]][path[1]][i]
    for name, path in _NORMS.items():
        out[name] = np_blocks[path[0]][path[1]][i]
    return out
