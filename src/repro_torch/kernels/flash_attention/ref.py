"""Plain PyTorch version of ``flash_attention``.

The counterpart of the JAX package's ``flash_attention_ref``: one einsum
of scores in fp32, the causal mask with the queries as the last ``Sq`` of
the ``Skv`` positions, softmax, one einsum with V. One difference, which
follows the Pallas kernel rather than its oracle: a causal query row that
sees no key (``Sq > Skv``) is exactly 0 here, where the JAX oracle returns
the mean of V (ROADMAP.md, section 3). The CPU path of
:mod:`~repro_torch.kernels.flash_attention.ops` runs this, and the card's
parity checks hold the CUDA kernel against it.

:func:`flash_attention_ref_backward` is the attention gradient of this
function, the backward of the training path's autograd Function on either
device (the JAX package has no backward kernel: XLA differentiates its
plain attention).
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


# the most fp32 scores one backward chunk holds (512 MiB): the chunk's
# recompute keeps a few copies of them alive
BACKWARD_SCORE_FLOATS = 1 << 27


def flash_attention_ref_backward(q, k, v, dout, *, causal: bool = True,
                                 scale: float | None = None):
    """``(dq, dk, dv)`` of :func:`flash_attention_ref` at ``(q, k, v)``
    for the output gradient ``dout`` (B, Sq, H, DV): the plain version
    recomputed under autograd, one chunk of batch rows and KV heads at a
    time. Rows and KV-head groups are independent (query head ``h`` reads
    only KV head ``h // G``), so each chunk's gradient is the whole
    function's there; a chunk holds at most ``BACKWARD_SCORE_FLOATS``
    fp32 scores (a KV head's G query heads are never split)."""
    B, Sq, H, _ = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    per_head = G * Sq * Skv
    kh = max(1, min(K, BACKWARD_SCORE_FLOATS // per_head))
    rows = max(1, min(B, BACKWARD_SCORE_FLOATS // (per_head * K))) \
        if kh == K else 1
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.enable_grad():
        for b0 in range(0, B, rows):
            b = slice(b0, b0 + rows)
            for k0 in range(0, K, kh):
                kk, hh = slice(k0, k0 + kh), slice(k0 * G, (k0 + kh) * G)
                ins = [t[b, :, s].detach().requires_grad_(True)
                       for t, s in ((q, hh), (k, kk), (v, kk))]
                out = flash_attention_ref(*ins, causal=causal, scale=scale)
                grads = torch.autograd.grad(out, ins, dout[b, :, hh])
                for acc, s, g in zip((dq, dk, dv), (hh, kk, kk), grads):
                    acc[b, :, s] = g
    return dq, dk, dv
