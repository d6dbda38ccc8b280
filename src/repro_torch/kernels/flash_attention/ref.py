"""Plain PyTorch version of ``flash_attention``.

The counterpart of the JAX package's ``flash_attention_ref``: one einsum
of scores in fp32, the causal mask with the queries as the last ``Sq`` of
the ``Skv`` positions, softmax, one einsum with V. One difference, which
follows the Pallas kernel rather than its oracle: a causal query row that
sees no key (``Sq > Skv``) is exactly 0 here, where the JAX oracle returns
the mean of V (ROADMAP.md, section 3). The CPU path of
:mod:`~repro_torch.kernels.flash_attention.ops` runs this, and the card's
parity checks hold the CUDA kernel against it.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        scale: float | None = None):
    """q: (B, Sq, H, D); k: (B, Skv, K, D); v: (B, Skv, K, DV) with H = K *
    G (query head ``h`` reads KV head ``h // G``); DV may differ from D
    (MLA: 192 and 128). Returns (B, Sq, H, DV) in q's dtype; the math is
    fp32."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    DV = v.shape[-1]
    G = H // K
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Sq, K, G, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        allow = torch.arange(Skv, device=q.device)[None, :] <= q_pos
        s = torch.where(allow, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    if causal and Sq > Skv:                     # rows that see no key
        sees = (torch.arange(Sq, device=q.device) + (Skv - Sq)) >= 0
        out = torch.where(sees[None, :, None, None, None], out, 0.0)
    return out.reshape(B, Sq, H, DV).to(q.dtype)
