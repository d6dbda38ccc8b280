"""Shared primitive layers: norms, RoPE, FFNs, embeddings, inits.

Plain functions on tensors, the counterparts of the JAX package's
``models/layers.py``. Weight matrices keep its ``(d_in, d_out)`` layout
(``x @ W``), so the same numbers give the same products. Matmuls run in the
tensors' dtype (the model's compute dtype); norm, RoPE and softmax
statistics run in fp32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import is_dtensor


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


def yarn_mscale(scale: float, m: float) -> float:
    """YaRN's attention term ``0.1 m ln(scale) + 1`` (1 where ``scale``
    is at most 1)."""
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_frequencies(head_dim: int, theta: float, yarn,
                     device=None) -> torch.Tensor:
    """``(head_dim / 2,)`` fp32 inverse frequencies under YaRN (``yarn`` a
    :class:`~repro_torch.configs.base.YarnConfig`), as DeepSeek-V2 sets
    them: with ``dim(r) = head_dim ln(orig / (2 pi r)) / (2 ln theta)``,
    the dims below ``low = floor(dim(beta_fast))`` keep their frequency,
    those above ``high = ceil(dim(beta_slow))`` take it over ``factor``,
    and a linear ramp joins them."""
    def dim_of(rotations):
        return (head_dim * math.log(yarn.original_max_position_embeddings
                                    / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(dim_of(yarn.beta_fast)), 0)
    high = min(math.ceil(dim_of(yarn.beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    i = np.arange(head_dim // 2, dtype=np.float64)
    keep = 1.0 - np.clip((i - low) / (high - low), 0.0, 1.0)
    inv = theta ** (-2.0 * i / head_dim) * (keep + (1.0 - keep) / yarn.factor)
    return torch.from_numpy(inv.astype(np.float32)).to(device)


def _frequencies(head_dim: int, theta: float, yarn, device):
    if yarn is None:
        return rope_frequencies(head_dim, theta, device)
    return yarn_frequencies(head_dim, theta, yarn, device)


# the inverse frequencies on each device, by (head_dim, theta, device),
# and YaRN's behind them
_ROPE_TABLES: dict = {}


def _rope_table(head_dim: int, theta: float, x: torch.Tensor, yarn=None):
    """:func:`rope_frequencies` (:func:`yarn_frequencies` with ``yarn``)
    on ``x``'s device, built once per ``(head_dim, theta, device[, yarn])``
    and kept: a step then copies nothing from the host, and a copy from
    pageable memory would wait for the card. A fake ``x`` (the dry run)
    gets a table of its own, which no later call outside that fake mode
    may see."""
    if type(x) is not torch.Tensor:        # only a subclass can be fake
        from torch._subclasses.fake_tensor import is_fake
        if is_fake(x):
            return _frequencies(head_dim, theta, yarn, x.device)
    key = (head_dim, float(theta), x.device) + (() if yarn is None
                                                 else (yarn,))
    table = _ROPE_TABLES.get(key)
    if table is None:
        table = _ROPE_TABLES[key] = _frequencies(head_dim, theta, yarn,
                                                 x.device)
    return table


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float, yarn=None) -> torch.Tensor:
    """Half-split RoPE in fp32. x: (..., seq, heads, head_dim); positions
    broadcastable to (..., seq). ``yarn`` (a ``YarnConfig``) takes YaRN's
    frequencies and scales cos and sin by ``mscale(factor, mscale) /
    mscale(factor, mscale_all_dim)``."""
    head_dim = x.shape[-1]
    freqs = _rope_table(head_dim, theta, x, yarn)               # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                       # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    if yarn is not None:
        m = (yarn_mscale(yarn.factor, yarn.mscale)
             / yarn_mscale(yarn.factor, yarn.mscale_all_dim))
        if m != 1.0:
            cos, sin = cos * m, sin * m
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
    """Rows of ``table`` for ``tokens``: the gather ``table[tokens]``,
    through ``F.embedding``, whose backward on the card sums a row's
    gradients in fp32 (a bf16 table's too), where the accumulating
    ``index_put_`` of ``table[tokens]`` adds in the table's dtype. A DTensor
    table (its vocab sliced over a mesh) takes
    :func:`_vocab_parallel_embed`."""
    if is_dtensor(table):
        out = _vocab_parallel_embed(table, tokens)
    else:
        out = F.embedding(tokens, table)
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


def cross_entropy_loss(logits, labels, mask=None):
    """logits fp32 (..., V); labels int (...). Returns the mean NLL
    (logsumexp minus the gold logit) over ``mask`` (all positions when
    None). A column masked to -1e30 by :func:`lm_logits` has softmax
    weight exactly 0, so it takes exactly 0 gradient. DTensor logits whose
    vocab the mesh shards take :func:`_vocab_parallel_nll`."""
    if is_dtensor(logits):
        nll = _vocab_parallel_nll(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def _vocab_parallel_nll(logits, labels):
    """The NLL of DTensor ``logits`` (..., V) at ``labels`` on each rank's
    slice of the vocab: the max, the sum of exponentials and the gold
    logit (0 where the label lies in another slice) each reduced over the
    mesh dims that slice V — no rank gathers the logits. A ``Partial``
    on the logits is reduce-scattered onto V first (all-reduced where V
    does not divide)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import (all_reduce_sum, dim_shards,
                                                  resolve_partial)
    logits = resolve_partial(logits, -1, "vocab_parallel_nll")
    rows, index, group = dim_shards(logits, -1)

    def nll(lg, lb):
        n = lg.shape[-1]
        m = lg.amax(dim=-1, keepdim=True).detach()
        if group is not None:
            m = funcol.all_reduce(m, "max", group)
        se = torch.exp(lg - m).sum(dim=-1)
        at = lb.long() - index * n
        ok = (at >= 0) & (at < n)
        gold = torch.gather(lg, -1, at.clamp(0, n - 1)[..., None])[..., 0]
        gold = torch.where(ok, gold, 0.0)
        if group is not None:
            se = all_reduce_sum(se, group)
            gold = all_reduce_sum(gold, group)
        return m[..., 0] + torch.log(se) - gold
    return local_map(nll, out_placements=list(rows),
                     in_placements=(tuple(logits.placements), rows),
                     device_mesh=logits.device_mesh,
                     redistribute_inputs=True)(logits, labels)


def _vocab_parallel_embed(table, tokens):
    """Rows of DTensor ``table`` (V, d) for DTensor ``tokens`` on each
    rank's slice of the vocab: a row from another slice is 0 here, and one
    sum over the mesh dims that slice V completes every row. The output
    is placed as ``tokens``; where ``tokens`` are sharded on a mesh dim
    that slices V too (an SSM or hybrid train cell folds ``model`` into
    the batch), the lookup gathers them there first, so every rank of the
    sum looks up the same tokens, and keeps its own rows after."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import (all_reduce_sum, dim_shards,
                                                  local_placements,
                                                  resolve_partial)
    table = resolve_partial(table, 0, "vocab_parallel_embed")
    _, index, group = dim_shards(table, 0)

    def look(tbl, tok):
        n = tbl.shape[0]
        at = tok - index * n
        ok = (at >= 0) & (at < n)
        out = torch.where(ok[..., None], F.embedding(at.clamp(0, n - 1), tbl),
                          0.0)
        if group is not None:
            out = all_reduce_sum(out, group)
        return out
    place = local_placements(tokens.placements, "vocab_parallel_embed")
    look_place = tuple(Replicate() if t == Shard(0) else pl
                       for pl, t in zip(place, table.placements))
    # the table's gradient: Partial where its rows are whole but the
    # tokens split (each rank adds its own tokens' rows)
    grad = tuple(Partial() if t == Replicate() and pl != Replicate() else t
                 for t, pl in zip(table.placements, look_place))
    out = local_map(look, out_placements=list(look_place),
                    in_placements=(tuple(table.placements), look_place),
                    in_grad_placements=(grad, look_place),
                    device_mesh=table.device_mesh,
                    redistribute_inputs=True)(table, tokens)
    return out if look_place == place else out.redistribute(
        out.device_mesh, place)
