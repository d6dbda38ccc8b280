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
(the dry run) and on a real process group. Their gradients are stated,
not left to the collectives' registered backwards: the output sum's
passes through (``sharding.all_reduce_sum``), the tokens' and the
router's are each rank's share (``Partial``), and only the first
``model`` rank passes the aux loss's on.

A drop-free config (``MoEConfig.drop_free``, DeepSeek-V2 as published)
takes :func:`_moe_drop_free` instead, on one device: the router's
``topk_method`` over all of its experts (:func:`_select`; DeepSeek-V2's
group-limited greedy top-k, weights not renormalised and scaled), then
the experts the layer holds (``first_held .. first_held + held - 1``,
one chip's share of an expert-parallel layer; an absent expert adds
nothing and nothing stands in for it), with no capacity: every (token,
held expert) pair is computed. A serving step hands the layer its valid
slots (:class:`Route`): only those are routed, so a token's output does
not depend on its batch and no padding slot takes an expert's work. The
pairs are sorted by held expert and each expert's rows multiplied as one
group (``torch._grouped_mm`` on an sm90 card in bf16, a ``bmm`` over a
per-expert buffer elsewhere), with no host read; each token's ``k``
contributions are added in a fixed order. While a profiler records, the
layer's parts are the ranges ``repro_torch.moe.route``, ``.experts`` and
``.shared``; each call adds its work to the route's tally, which the
serving engine counts (``expert_rows``, ``routed_slots``,
``experts_run``).
"""
from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch

from repro_torch import telemetry
from repro_torch.distributed.sharding import settle_residual
from repro_torch.models.layers import _act, apply_ffn, ffn_matrices


def moe_matrices(cfg) -> dict:
    """MoE FFN matrix name → (shape, JAX pytree path below the block's
    ``ffn``): the router (over all ``num_experts``), the stacked
    ``experts.*`` of the experts the layer holds (always gated, one
    ``(d_in, d_out)`` matrix per expert), and the ``shared``/``dense``
    FFNs (gated for a GLU activation)."""
    m, d = cfg.moe, cfg.d_model
    out = {"router": ((d, m.num_experts), ("router",))}
    for n, shape in (("w_gate", (m.held, d, m.d_expert)),
                     ("w_up", (m.held, d, m.d_expert)),
                     ("w_down", (m.held, m.d_expert, d))):
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


# ---------------------------------------------------------------------------
# Drop-free routing over a held share of the experts
# ---------------------------------------------------------------------------
class Route(NamedTuple):
    """What one serving forward tells its drop-free MoE layers. ``valid``
    (B, S) bool marks the slots that hold a real token (None: every slot);
    ``n_valid`` is their count, known on the host: the layer gathers
    exactly those tokens and routes them. Each layer appends its work to
    ``tally``, int64 on the device: ``(expert_rows, experts_run,
    routed_slots)``, the (token, held expert) pairs computed, the held
    experts given at least one row, and the slots routed."""
    valid: Optional[torch.Tensor]
    n_valid: int
    tally: list


def tally(route) -> Optional[torch.Tensor]:
    """The (3,) sum of a forward's layer tallies, or None (no drop-free
    layer ran)."""
    if route is None or not route.tally:
        return None
    return torch.stack(route.tally).sum(0)


def _select(probs, m):
    """The experts and weights of each token under ``m.topk_method``:
    ``(ids (T, k), weights (T, k) fp32)``. ``probs`` (T, E) are the
    softmax scores. ``"group_limited_greedy"`` (DeepSeek-V2) scores each
    of the ``n_group`` groups of consecutive experts by its best, keeps
    the top ``topk_group`` groups and zeroes the other scores, then takes
    the top-k of what is left; ``"greedy"`` the top-k of all. Ties go to
    the lower id (a stable sort, as ``lax.top_k``). The weights are the
    kept scores, renormalised to sum 1 only with ``norm_topk_prob``, times
    ``routed_scaling_factor``."""
    scores = probs
    if m.topk_method == "group_limited_greedy":
        T, E = probs.shape
        per = E // m.n_group
        best = probs.view(T, m.n_group, per).amax(-1)           # (T, G)
        top = torch.sort(best, dim=-1, descending=True,
                         stable=True).indices[:, :m.topk_group]
        kept = torch.zeros_like(best, dtype=torch.bool).scatter_(1, top, True)
        scores = probs.masked_fill(~kept.repeat_interleave(per, dim=1), 0.0)
    elif m.topk_method != "greedy":
        raise ValueError(f"unknown topk_method {m.topk_method!r}")
    w, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    w, ids = w[:, :m.top_k], ids[:, :m.top_k]
    if m.norm_topk_prob:
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    return ids, w * m.routed_scaling_factor


@functools.lru_cache(maxsize=None)
def _sm90(device) -> bool:
    return torch.cuda.get_device_capability(device) >= (9, 0)


def _grouped(rows, experts) -> bool:
    """Take ``torch._grouped_mm`` (CUTLASS's grouped GEMM, sm90, bf16)?"""
    return (rows.is_cuda and rows.dtype == torch.bfloat16
            and experts.w_gate.dtype == torch.bfloat16
            and hasattr(torch, "_grouped_mm") and _sm90(rows.device))


def _expert_products(experts, rows, key, counts, ends, cap: int,
                     activation: str):
    """Each held expert's GLU FFN over its rows. ``rows`` (N, d) are
    sorted by ``key`` (N,), the held expert of each (``E``: none), so
    expert ``e``'s rows are ``ends[e] - counts[e] .. ends[e] - 1``;
    ``cap`` bounds any expert's rows. Returns (N, d): a row past
    ``ends[-1]`` holds anything."""
    if _grouped(rows, experts):
        offs = ends.to(torch.int32)
        h = _act(activation, torch._grouped_mm(rows, experts.w_gate,
                                               offs=offs))
        h.mul_(torch._grouped_mm(rows, experts.w_up, offs=offs))
        return torch._grouped_mm(h, experts.w_down, offs=offs)
    # elsewhere: one (E, cap, d) buffer and bmm; rows of no held expert go
    # to a spare slot that no product reads
    E = counts.shape[0]
    e = key.clamp_max(E - 1)
    slot = torch.where(key < E, torch.arange(key.shape[0], device=key.device)
                       - (ends - counts)[e], cap)
    buf = rows.new_zeros((E, cap + 1, rows.shape[1]))
    buf[e, slot] = rows
    buf = buf[:, :cap]
    h = _act(activation, torch.bmm(buf, experts.w_gate))
    h.mul_(torch.bmm(buf, experts.w_up))
    return torch.bmm(h, experts.w_down)[e, slot.clamp_max(cap - 1)]


def held_experts(experts, x, ids, w, m, activation: str):
    """The routed part of a drop-free layer over the tokens ``x`` (n, d):
    Σ over each token's ``k`` experts that the layer holds of weight ×
    expert(x), with no capacity. The (token, expert) pairs are sorted by
    held expert
    (a stable sort: token order within an expert) and each expert's rows
    multiplied as one group; each token's ``k`` contributions are added
    in fp32 (or wider) in the order of its ``ids``, a fixed order.
    Returns ``(y (n, d), expert_rows, experts_run)``, the two counts 0-d
    int64 on the device: no host read."""
    n, k = ids.shape
    E = m.held
    e = ids - m.first_held
    held = (e >= 0) & (e < E)
    key = torch.where(held, e, E).reshape(-1)                 # (n k,)
    order = torch.argsort(key, stable=True)
    counts = _counts(key, E + 1, torch.long)[:E]
    ends = torch.cumsum(counts, 0)
    out = _expert_products(experts, x[order // k], key[order], counts, ends,
                           n, activation)
    back = torch.empty_like(order)
    back[order] = torch.arange(n * k, device=order.device)
    acc = torch.promote_types(x.dtype, torch.float32)
    parts = torch.where(held[..., None], out[back].view(n, k, -1).to(acc),
                        0.0) * w[..., None].to(acc)
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]
    return y.to(x.dtype), ends[-1], (counts > 0).sum()


def _moe_drop_free(p, cfg, x_flat, route):
    """The drop-free layer over ``x_flat`` (T, d): route the valid slots,
    run the held experts and the shared ones; a slot not routed gets 0.
    Returns ``(y (T, d), aux)``. A serving forward passes its ``route``
    and gets no ``aux``; the loss path (``route`` None) routes every slot
    and asks for ``aux``, the GShard load-balancing loss (not DeepSeek-V2's
    balance losses)."""
    m = cfg.moe
    T = x_flat.shape[0]
    idx = None
    with telemetry.span(telemetry.MOE_ROUTE):
        if route is not None and route.valid is not None:
            if route.n_valid is None:
                raise ValueError("a Route that marks valid slots needs "
                                 "their count, n_valid")
            # the valid slots, in slot order, by a sort of fixed size
            idx = torch.argsort((~route.valid.reshape(T)).to(torch.uint8),
                                stable=True)[:route.n_valid]
        x = x_flat if idx is None else x_flat[idx]
        probs = torch.softmax(x.float() @ p.router.float(), dim=-1)
        ids, w = _select(probs, m)
    with telemetry.span(telemetry.MOE_EXPERTS):
        y, rows, run = held_experts(p.experts, x, ids, w, m,
                                    cfg.ffn_activation)
    with telemetry.span(telemetry.MOE_SHARED):
        for part in ("shared", "dense"):
            ffn = getattr(p, part, None)
            if ffn is not None:
                y = y + apply_ffn(ffn, x, cfg.ffn_activation)
    if idx is not None:
        y = x_flat.new_zeros(x_flat.shape).index_copy_(0, idx, y)
    if route is None:
        ce = _counts(ids.reshape(-1), m.num_experts, torch.float32) \
            / (x.shape[0] * m.top_k)
        return y, m.num_experts * torch.sum(probs.mean(dim=0) * ce)
    routed = torch.full((), x.shape[0], dtype=torch.long, device=x.device)
    route.tally.append(torch.stack([rows, run, routed]))
    return y, None


def apply_moe(p, cfg, x, ep_axes=(), route=None):
    """x: (B, S, d). Returns (y, aux_loss). ``p`` carries ``router``, the
    stacked ``experts`` and, where the config has them, the ``shared`` and
    ``dense`` FFNs. A drop-free config takes :func:`_moe_drop_free`
    (``route``: a serving step's valid slots and tally; None on the loss
    path, which routes every token and gets the aux loss). With ``ep_axes`` (the data axes) and ``x`` a DTensor
    whose mesh has a ``model`` axis, dispatch goes through an EP path;
    otherwise the single-device path."""
    m = cfg.moe
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    mesh = getattr(x, "device_mesh", None)
    use_ep = bool(ep_axes) and mesh is not None \
        and "model" in (mesh.mesh_dim_names or ())
    if m.drop_free:
        if mesh is not None:
            raise NotImplementedError(
                "a drop-free MoE layer runs on one device (its held experts "
                "are its share of an expert-parallel layer)")
        y, aux = _moe_drop_free(p, cfg, x_flat, route)
        return y.reshape(B, S, d), aux
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
            y = y + settle_residual(apply_ffn(ffn, x_flat, cfg.ffn_activation),
                                    x_flat)
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
    """``body`` as a ``local_map`` over the tokens, the router and the
    experts. The gradients of the tokens (on each mesh dim they are
    replicated on) and of the router (on every mesh dim) are each rank's
    share, Partial: a rank's experts, hidden slice or tokens give only
    their part of the sum."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    e = p.experts
    share = tuple(Partial() if pl == Replicate() else pl for pl in tok_place)
    fn = local_map(
        body, out_placements=(tok_place, places["aux"]),
        in_placements=(tok_place, places["router"], places["w_gate"],
                       places["w_up"], places["w_down"]),
        in_grad_placements=(share, (Partial(),) * mesh.ndim,
                            places["w_gate"], places["w_up"],
                            places["w_down"]),
        device_mesh=mesh, redistribute_inputs=True)
    y, aux_arr = fn(x_flat, p.router, e.w_gate, e.w_up, e.w_down)
    return y, aux_arr.mean()


def _aux_share(aux, model_rank):
    """The aux loss as a body's output ``(1,)``: every ``model`` rank
    holds the same value, and only the first passes its gradient to the
    router (whose gradient sums the ranks' shares)."""
    return (aux if model_rank == 0 else aux.detach())[None]


def _moe_ep(p, cfg, x_flat, ep_axes, mesh):
    """EP with the expert weights gathered: tokens are data-sharded and
    replicated over ``model``, so every model rank routes the same local
    tokens, keeps only its ``E_loc`` experts' assignments, runs them and
    all-reduces the partial outputs over ``model``. The FSDP'd expert
    hidden dim is all-gathered over the data axes inside the region."""
    from repro_torch.distributed.sharding import (P, all_gather,
                                                  all_reduce_sum, axis_group,
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
        y = all_reduce_sum(y, axis_group(mesh, ("model",)))
        return y, _aux_share(aux, rank)

    tok_place = to_placements(P(dp if dp else None, None), mesh)
    return _ep_call(local, p, x_flat, tok_place, places, mesh)


def _moe_ep_tokengather(p, cfg, x_flat, ep_axes, mesh):
    """EP for decode-scale batches: the weights never move. Each rank
    all-gathers the tokens over the data axes (when they shard evenly),
    runs its ``E_loc`` experts on its slice of their hidden dim (exact:
    the hidden dim is elementwise through the gate), and one all-reduce
    over the data axes and ``model`` completes both the expert and the
    hidden-slice sums; each rank keeps its own tokens' rows."""
    from repro_torch.distributed.sharding import (P, all_gather,
                                                  all_reduce_sum, axis_group,
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
        # each data rank keeps its own tokens' rows of the sum: their
        # gradients gathered over the data axes are the sum's
        y_all = all_reduce_sum(y_all, axis_group(mesh, dp + ("model",)),
                               axis_group(mesh, dp) if tokens_sharded
                               else None)
        if tokens_sharded:
            y_all = y_all[idx * T_loc:(idx + 1) * T_loc]
        return y_all, _aux_share(aux, rank)

    tok_place = to_placements(P(dp if tokens_sharded else None, None), mesh)
    return _ep_call(local, p, x_flat, tok_place, places, mesh)
