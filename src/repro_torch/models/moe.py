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

Expert counts are a fixed-size ``scatter_add`` of ones (``bincount``'s
output size depends on the data, which a fake tensor has not).

Expert parallelism (``apply_moe(..., ep_axes)`` on DTensors whose mesh has
a ``model`` axis) is the reference's: each ``model`` rank holds
``E / n_model`` experts (``E_loc``), their hidden dim FSDP-sharded over
the data axes. :func:`_moe_ep` all-gathers that hidden dim, routes the
rank's own tokens (replicated over ``model``), runs its local experts and
all-reduces the partial outputs over ``model``; at decode-scale token
counts (``B·S ≤ 4096``) :func:`_moe_ep_tokengather` instead all-gathers
the tokens over the data axes, runs its experts on its hidden slice and
all-reduces over the data axes and ``model`` at once. Each is a
``local_map`` body (the ``shard_map`` counterpart) with functional
collectives, so the same code runs on a ``fake`` world of fake tensors
(the dry run) and on a real process group.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

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
    ce = _counts(top_ids.reshape(-1), num_experts, torch.float32) \
        / (T * top_k)
    aux = num_experts * torch.sum(me * ce)
    return top_ids, top_w, aux


def _counts(ids, n: int, dtype):
    """How often each of ``0..n-1`` occurs in ``ids``, as ``dtype`` (the
    counts of ``bincount(ids, minlength=n)``, at a fixed size)."""
    return torch.zeros(n, dtype=dtype, device=ids.device).scatter_add_(
        0, ids, torch.ones(ids.shape, dtype=dtype, device=ids.device))


def moe_dispatch_combine(experts, x_flat, top_ids, top_w, num_experts: int,
                         capacity: int, activation: str, first: int = 0,
                         n_local: int | None = None):
    """Sort-based capacity dispatch → per-expert GLU FFN → weighted
    combine. ``experts`` carries ``w_gate``/``w_up``/``w_down`` stacked
    ``(n_local, d_in, d_out)``: experts ``first .. first + n_local - 1``
    (all of them by default); a token's entry for any other expert
    contributes 0, as one past its expert's capacity does."""
    T, d = x_flat.shape
    k = top_ids.shape[-1]
    dev = x_flat.device
    n_local = num_experts if n_local is None else n_local
    flat_e = top_ids.reshape(-1)                               # (T*k,)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = _counts(sorted_e, num_experts, torch.long)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=dev) - starts[sorted_e]
    keep = pos_in_e < capacity
    eid = sorted_e
    if n_local != num_experts:
        eid = sorted_e - first
        keep = keep & (eid >= 0) & (eid < n_local)
        eid = eid.clamp(0, n_local - 1)
    slot = torch.where(keep, pos_in_e, capacity)     # the spare slot
    tok_idx = sort_idx // k

    xbuf = x_flat.new_zeros((n_local, capacity + 1, d))
    xbuf[eid, slot] = x_flat[tok_idx]
    xbuf = xbuf[:, :capacity]
    h = _act(activation, torch.bmm(xbuf, experts.w_gate))
    h.mul_(torch.bmm(xbuf, experts.w_up))        # in place: one less buffer
    ybuf = torch.bmm(h, experts.w_down)

    gathered = torch.where(keep[:, None],       # a dropped entry gives 0
                           ybuf[eid, slot.clamp_max(capacity - 1)], 0)
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


def apply_moe(p, cfg, x, ep_axes=()):
    """x: (B, S, d). Returns (y, aux_loss). ``p`` carries ``router``, the
    stacked ``experts`` and, where the config has them, the ``shared`` and
    ``dense`` FFNs. With ``ep_axes`` (the data axes) and ``x`` a DTensor
    whose mesh has a ``model`` axis, dispatch goes through an EP path;
    otherwise the single-device path."""
    m = cfg.moe
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    mesh = getattr(x, "device_mesh", None)
    use_ep = bool(ep_axes) and mesh is not None \
        and "model" in (mesh.mesh_dim_names or ())
    if use_ep and B * S <= 4096:
        # decode-scale token counts: move the (few) tokens, not the FSDP'd
        # expert weights
        y, aux = _moe_ep_tokengather(p, cfg, x_flat, ep_axes, mesh)
    elif use_ep:
        y, aux = _moe_ep(p, cfg, x_flat, ep_axes, mesh)
    else:
        top_ids, top_w, aux = _route(p.router, x_flat, m.num_experts,
                                     m.top_k)
        capacity = int(m.capacity_factor * (B * S * m.top_k)
                       / m.num_experts)
        capacity = max(capacity, 4)
        y = moe_dispatch_combine(p.experts, x_flat, top_ids, top_w,
                                 m.num_experts, capacity,
                                 cfg.ffn_activation)
    for part in ("shared", "dense"):
        ffn = getattr(p, part, None)
        if ffn is not None:
            y = y + apply_ffn(ffn, x_flat, cfg.ffn_activation)
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Expert parallelism (local_map bodies)
# ---------------------------------------------------------------------------
def _ep_layout(mesh, ep_axes):
    from repro_torch.distributed.sharding import P, to_placements
    dp = tuple(a for a in ep_axes if a in mesh.mesh_dim_names)
    dp_size = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                        for a in dp) if dp else 1
    d_or_none = dp if dp else None
    places = {
        "w_gate": to_placements(P("model", None, d_or_none), mesh),
        "w_up": to_placements(P("model", None, d_or_none), mesh),
        "w_down": to_placements(P("model", d_or_none, None), mesh),
        "router": to_placements(P(None, None), mesh),
        "aux": to_placements(P(d_or_none), mesh),
    }
    return dp, dp_size, places


def _ep_call(body, p, x_flat, tok_place, places, mesh):
    from torch.distributed.tensor.experimental import local_map
    e = p.experts
    fn = local_map(
        body, out_placements=(tok_place, places["aux"]),
        in_placements=(tok_place, places["router"], places["w_gate"],
                       places["w_up"], places["w_down"]),
        device_mesh=mesh, redistribute_inputs=True)
    y, aux_arr = fn(x_flat, p.router, e.w_gate, e.w_up, e.w_down)
    return y, aux_arr.mean()


def _moe_ep(p, cfg, x_flat, ep_axes, mesh):
    """EP with the expert weights gathered: tokens are data-sharded and
    replicated over ``model``, so every model rank routes the same local
    tokens, keeps only its ``E_loc`` experts' assignments, runs them and
    all-reduces the partial outputs over ``model``. The FSDP'd expert
    hidden dim is all-gathered over the data axes inside the region."""
    import torch.distributed._functional_collectives as funcol

    from repro_torch.distributed.sharding import (P, all_gather, axis_group,
                                                  to_placements)
    m = cfg.moe
    dp, dp_size, places = _ep_layout(mesh, ep_axes)
    n_model = mesh.size(mesh.mesh_dim_names.index("model"))
    T_loc = x_flat.shape[0] // dp_size
    capacity = max(int(m.capacity_factor * (T_loc * m.top_k)
                       / m.num_experts), 4)
    E_loc = m.num_experts // n_model
    rank = mesh.get_local_rank("model")

    def local(x_loc, router_w, w_gate, w_up, w_down):
        if dp:
            g = axis_group(mesh, dp)
            w_gate = all_gather(w_gate, 2, g)
            w_up = all_gather(w_up, 2, g)
            w_down = all_gather(w_down, 1, g)
        top_ids, top_w, aux = _route(router_w, x_loc, m.num_experts, m.top_k)
        y = moe_dispatch_combine(
            SimpleNamespace(w_gate=w_gate, w_up=w_up, w_down=w_down), x_loc,
            top_ids, top_w, m.num_experts, capacity, cfg.ffn_activation,
            first=rank * E_loc, n_local=E_loc)
        y = funcol.all_reduce(y, "sum", axis_group(mesh, ("model",)))
        return y, aux[None]

    tok_place = to_placements(P(dp if dp else None, None), mesh)
    return _ep_call(local, p, x_flat, tok_place, places, mesh)


def _moe_ep_tokengather(p, cfg, x_flat, ep_axes, mesh):
    """EP for decode-scale batches: the weights never move. Each rank
    all-gathers the tokens over the data axes (when they shard evenly),
    runs its ``E_loc`` experts on its slice of their hidden dim (exact:
    the hidden dim is elementwise through the gate), and one all-reduce
    over the data axes and ``model`` completes both the expert and the
    hidden-slice sums; each rank keeps its own tokens' rows."""
    import torch.distributed._functional_collectives as funcol

    from repro_torch.distributed.sharding import (P, all_gather, axis_group,
                                                  to_placements)
    m = cfg.moe
    dp, dp_size, places = _ep_layout(mesh, ep_axes)
    n_model = mesh.size(mesh.mesh_dim_names.index("model"))
    T = x_flat.shape[0]
    tokens_sharded = bool(dp) and T % dp_size == 0
    T_loc = T // dp_size if tokens_sharded else T
    capacity = max(int(m.capacity_factor * (T * m.top_k)
                       / m.num_experts), 4)
    E_loc = m.num_experts // n_model
    rank = mesh.get_local_rank("model")
    idx = 0
    for a in dp:                 # this rank's index over the data axes
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) \
            + mesh.get_local_rank(a)

    def local(x_loc, router_w, w_gate, w_up, w_down):
        x_all = x_loc
        if tokens_sharded:
            x_all = all_gather(x_loc, 0, axis_group(mesh, dp))
        top_ids, top_w, aux = _route(router_w, x_all, m.num_experts, m.top_k)
        y_all = moe_dispatch_combine(
            SimpleNamespace(w_gate=w_gate, w_up=w_up, w_down=w_down), x_all,
            top_ids, top_w, m.num_experts, capacity, cfg.ffn_activation,
            first=rank * E_loc, n_local=E_loc)
        y_all = funcol.all_reduce(y_all, "sum",
                                  axis_group(mesh, dp + ("model",)))
        if tokens_sharded:
            y_all = y_all[idx * T_loc:(idx + 1) * T_loc]
        return y_all, aux[None]

    tok_place = to_placements(P(dp if tokens_sharded else None, None), mesh)
    return _ep_call(local, p, x_flat, tok_place, places, mesh)
