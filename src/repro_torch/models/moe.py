"""Mixture-of-experts FFN: top-k routing with capacity and sort-based
dispatch, with DeepSeek-V2's shared experts and Arctic's parallel dense
residual.

The counterpart of the single-device path of the JAX package's
``models/moe.py``. Its expert products are einsums outside any Pallas
kernel, so here they are ``torch.bmm`` over the same ``(E, d, f)``
stacked expert weights. Capacity is counted over every token of the call
— the flattened ``(B, S)`` block, padding slots and ``q_len == 0`` rows
included, which are routed and take slots as in the reference — so a
token's output depends on its batch at a capacity factor below no-drop.

Two places where torch differs from JAX are handled explicitly:

* JAX drops the scatter of a token past its expert's capacity
  (``mode="drop"``); here it lands in one spare slot per expert that no
  product reads.
* JAX adds each token's ``k`` weighted expert outputs into a zero buffer
  in dispatch order (ascending expert id). ``index_add_`` on CUDA adds
  with atomics in no fixed order, so here each token's ``k``
  contributions are gathered and added in that same order: the result is
  the same bits on every run.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import _act, apply_ffn, ffn_matrices


def moe_matrices(cfg) -> dict:
    """MoE FFN matrix name → (shape, JAX pytree path below the block's
    ``ffn``): the router, the stacked ``experts.*`` (always gated, one
    ``(d_in, d_out)`` matrix per expert), and the ``shared``/``dense``
    FFNs (gated for a GLU activation)."""
    m, d = cfg.moe, cfg.d_model
    out = {"router": ((d, m.num_experts), ("router",))}
    for n, shape in (("w_gate", (m.num_experts, d, m.d_expert)),
                     ("w_up", (m.num_experts, d, m.d_expert)),
                     ("w_down", (m.num_experts, m.d_expert, d))):
        out["experts." + n] = (shape, ("experts", n))
    ffns = []
    if m.num_shared_experts:
        ffns.append(("shared", m.d_expert * m.num_shared_experts))
    if m.dense_residual:
        ffns.append(("dense", m.d_dense_residual))
    for part, f in ffns:
        for n, shape in ffn_matrices(d, f, cfg.ffn_activation).items():
            out[f"{part}.{n}"] = (shape, (part, n))
    return out


def _route(router_w, x_flat, num_experts: int, top_k: int):
    """Returns (top_ids (T, k), top_w (T, k) fp32, aux_loss scalar): the
    router's product in fp32, top-k of the softmax (ties to the lower
    expert id, as ``lax.top_k``), weights normalised to sum 1, and the
    GShard load-balancing loss."""
    logits = x_flat.float() @ router_w.float()                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_ids = top_w[:, :top_k], top_ids[:, :top_k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    T = x_flat.shape[0]
    me = probs.mean(dim=0)                                     # (E,)
    ce = torch.bincount(top_ids.reshape(-1), minlength=num_experts).float() \
        / (T * top_k)
    aux = num_experts * torch.sum(me * ce)
    return top_ids, top_w, aux


def moe_dispatch_combine(experts, x_flat, top_ids, top_w, num_experts: int,
                         capacity: int, activation: str):
    """Sort-based capacity dispatch → per-expert GLU FFN → weighted
    combine. ``experts`` carries ``w_gate``/``w_up``/``w_down`` stacked
    ``(E, d_in, d_out)``."""
    T, d = x_flat.shape
    k = top_ids.shape[-1]
    dev = x_flat.device
    flat_e = top_ids.reshape(-1)                               # (T*k,)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = torch.bincount(sorted_e, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=dev) - starts[sorted_e]
    keep = pos_in_e < capacity
    slot = torch.where(keep, pos_in_e, capacity)     # the spare slot
    tok_idx = sort_idx // k

    xbuf = x_flat.new_zeros((num_experts, capacity + 1, d))
    xbuf[sorted_e, slot] = x_flat[tok_idx]
    xbuf = xbuf[:, :capacity]
    h = _act(activation, torch.bmm(xbuf, experts.w_gate))
    h.mul_(torch.bmm(xbuf, experts.w_up))        # in place: one less buffer
    ybuf = torch.bmm(h, experts.w_down)

    gathered = torch.where(keep[:, None],       # a dropped entry gives 0
                           ybuf[sorted_e, slot.clamp_max(capacity - 1)], 0)
    w_sorted = top_w.reshape(-1)[sort_idx].to(gathered.dtype)
    contrib = gathered * w_sorted[:, None]
    # each token's k entries by their place in the sorted order, which is
    # ascending expert id: the order JAX's scatter-add takes them in
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(T * k, device=dev)
    parts = contrib[torch.sort(inv.view(T, k), dim=1).values]  # (T, k, d)
    y = x_flat.new_zeros((T, d))
    for j in range(k):
        y = y + parts[:, j]
    return y


def apply_moe(p, cfg, x):
    """x: (B, S, d). Returns (y, aux_loss). ``p`` carries ``router``, the
    stacked ``experts`` and, where the config has them, the ``shared`` and
    ``dense`` FFNs."""
    m = cfg.moe
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    top_ids, top_w, aux = _route(p.router, x_flat, m.num_experts, m.top_k)
    capacity = int(m.capacity_factor * (B * S * m.top_k) / m.num_experts)
    capacity = max(capacity, 4)
    y = moe_dispatch_combine(p.experts, x_flat, top_ids, top_w,
                             m.num_experts, capacity, cfg.ffn_activation)
    for part in ("shared", "dense"):
        ffn = getattr(p, part, None)
        if ffn is not None:
            y = y + apply_ffn(ffn, x_flat, cfg.ffn_activation)
    return y.reshape(B, S, d), aux
