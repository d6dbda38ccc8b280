"""DeepSeek-V2's decoder in plain PyTorch, run a layer at a time: MLA
attention with YaRN RoPE, leading dense layers, then routed experts
(group-limited greedy routing) and shared experts.

fp32 with TF32 off, written from the published description (arXiv
2405.04434 §2.1-2.2 and the model's ``config.json``), independent of the
program: MLA with K and V expanded from the latent (no absorption), the
RoPE key shared by all heads, YaRN's frequencies and softmax scale, the
router's softmax over all experts, the top ``topk_group`` groups by
their best expert, the top-k within them, weights as the kept scores
times ``routed_scaling_factor`` (renormalised only with
``norm_topk_prob``). One departure, the configuration's: RoPE pairs the
rope dims half-split (the checkpoint's interleaved pairing is a fixed
permutation of the rope columns).

The experts are one chip's share (:class:`perfbench.moe_weights.MoEArch`):
the router scores all of them, and only the held ones are computed; an
absent expert adds nothing, as in the program.

``served_gaps`` is the serving cell's comparison, as the dense
reference's (:mod:`perfbench.reference.decoder`): every sampled sequence
(a prompt, then the tokens the program served for it) through the model,
one layer at a time over all of them, each layer's weights drawn again
from the seed; at each served position the gap by which the served
token's logit lies below the reference's best. ``control_gaps`` is the
control: every weight product's weight and input rounded to float8 e4m3
(the router, which the program runs in fp32, too), the gap read that of
the token the fp8 model puts first, measured by the fp32 model.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.moe_weights import MoEArch, draw, draw_layer
from perfbench.reference.decoder import (attention, exact_fp32, fp8_round,
                                         gaps, matmul, rmsnorm)


def yarn_mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def rope_inv_freq(a: MoEArch, device) -> torch.Tensor:
    """The rope dims' inverse frequencies (float64): YaRN's where the
    configuration scales RoPE (DeepSeek-V2's ``yarn_find_correction_range``
    and linear ramp), else ``theta^(-2i/d)``."""
    d = a.dr
    i = torch.arange(d // 2, dtype=torch.float64, device=device)
    base = a.theta ** (-2.0 * i / d)
    y = a.yarn
    if y is None:
        return base

    def corr(rot):
        return d * math.log(y["original_max_position_embeddings"]
                            / (rot * 2 * math.pi)) / (2 * math.log(a.theta))
    low = max(math.floor(corr(y["beta_fast"])), 0)
    high = min(math.ceil(corr(y["beta_slow"])), d - 1)
    if low == high:
        high += 0.001
    extra = 1.0 - ((i - low) / (high - low)).clamp(0.0, 1.0)
    return base * extra + base / y["factor"] * (1.0 - extra)


def rope(x, pos, inv, mscale=1.0):
    """Half-split rotary embedding; x (S, heads, dr), pos (S,)."""
    ang = pos.double()[:, None] * inv
    cos = (ang.cos() * mscale).float()[:, None]
    sin = (ang.sin() * mscale).float()[:, None]
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def softmax_scale(a: MoEArch) -> float:
    s = 1.0 / math.sqrt(a.dn + a.dr)
    y = a.yarn
    if y is not None and y.get("mscale_all_dim"):
        s *= yarn_mscale(y["factor"], y["mscale_all_dim"]) ** 2
    return s


def mla(a: MoEArch, w: dict, x, quant=None):
    """MLA over one sequence x (S, d), causal, K and V expanded from the
    latent."""
    S, H = x.shape[0], a.H
    pos = torch.arange(S, device=x.device)
    if a.q_lora:
        q = matmul(rmsnorm(matmul(x, w["w_dq"], quant), w["q_norm"], a.eps),
                   w["w_uq"], quant)
    else:
        q = matmul(x, w["w_q"], quant)
    q = q.view(S, H, a.dn + a.dr)
    c = rmsnorm(matmul(x, w["w_dkv"], quant), w["kv_norm"], a.eps)
    inv = rope_inv_freq(a, x.device)
    y = a.yarn
    ms = (1.0 if y is None else yarn_mscale(y["factor"], y["mscale"])
          / yarn_mscale(y["factor"], y["mscale_all_dim"]))
    q_pe = rope(q[..., a.dn:], pos, inv, ms)
    k_pe = rope(matmul(x, w["w_kr"], quant)[:, None], pos, inv, ms)
    k_nope = matmul(c, w["w_uk"].reshape(a.dc, H * a.dn), quant)
    v = matmul(c, w["w_uv"].reshape(a.dc, H * a.dv), quant).view(S, H, a.dv)
    k = torch.cat([k_nope.view(S, H, a.dn), k_pe.expand(S, H, a.dr)], -1)
    # attention() divides the scores by sqrt(dn + dr); YaRN's factor goes
    # on the queries
    qs = torch.cat([q[..., :a.dn], q_pe], -1) \
        * (softmax_scale(a) * math.sqrt(a.dn + a.dr))
    o = attention(qs, k, v).reshape(S, H * a.dv)
    return matmul(o, w["wo"], quant)


def route(a: MoEArch, x, router, quant=None):
    """Each token's experts and weights: ``(ids (S, k), weights (S, k))``,
    ids over all of the router's experts."""
    s = torch.softmax(matmul(x, router, quant), dim=-1)        # (S, E)
    if a.topk_method == "group_limited_greedy":
        S = s.shape[0]
        g = s.view(S, a.n_group, -1).max(dim=-1).values          # (S, G)
        top = g.topk(a.topk_group, dim=-1).indices
        mask = torch.zeros_like(g).scatter_(1, top, 1.0)
        s = s * mask.repeat_interleave(a.E // a.n_group, dim=1)
    elif a.topk_method != "greedy":
        raise ValueError(a.topk_method)
    wts, ids = s.topk(a.top_k, dim=-1)
    if a.norm_topk:
        wts = wts / wts.sum(-1, keepdim=True)
    return ids, wts * a.scale


def swiglu(x, wg, wu, wd, quant=None):
    return matmul(F.silu(matmul(x, wg, quant)) * matmul(x, wu, quant), wd,
                  quant)


def experts(a: MoEArch, w: dict, x, quant=None):
    """The routed experts this chip holds, and the shared ones, over x
    (S, d) (normed)."""
    ids, wts = route(a, x, w["router"], quant)
    y = torch.zeros_like(x)
    for e in range(a.E_held):
        hit = ids == a.first + e                                # (S, k)
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        we = (wts * hit)[rows].sum(-1)
        y[rows] += we[:, None] * swiglu(x[rows], w["experts.w_gate"][e],
                                        w["experts.w_up"][e],
                                        w["experts.w_down"][e], quant)
    if a.n_shared:
        y = y + swiglu(x, w["shared.w_gate"], w["shared.w_up"],
                       w["shared.w_down"], quant)
    return y


def _fp8_weights(w: dict) -> dict:
    """Every matrix rounded to float8 e4m3, an expert stack one scale an
    expert."""
    out = {}
    for n, t in w.items():
        if t.ndim == 1:
            out[n] = t
        elif n.startswith("experts."):
            out[n] = torch.stack([fp8_round(m) for m in t])
        else:
            out[n] = fp8_round(t)
    return out


def layer(a: MoEArch, i: int, w: dict, x, quant=None):
    """Pre-norm decoder layer ``i`` over one sequence x (S, d)."""
    x = x + mla(a, w, rmsnorm(x, w["ln_attn"], a.eps), quant)
    h = rmsnorm(x, w["ln_ffn"], a.eps)
    if i < a.n_dense:
        return x + swiglu(h, w["w_gate"], w["w_up"], w["w_down"], quant)
    return x + experts(a, w, h, quant)


@torch.no_grad()
def hidden_states(a: MoEArch, seed: int, seqs: list, device, quant=None,
                  weights=None):
    """The final hidden states (before the last norm) of each token
    sequence in ``seqs``, a layer at a time over all of them.
    ``weights(layer)`` overrides the draw from the seed (tests)."""
    table = draw(a, seed, "embed", device, torch.float32)
    xs = [table[s.to(device).long()] for s in seqs]
    del table
    for i in range(a.L):
        w = (weights(i) if weights is not None
             else draw_layer(a, seed, i, device, torch.float32))
        if quant == "fp8":
            w = _fp8_weights(w)
        xs = [layer(a, i, w, x, quant) for x in xs]
        del w
    return xs


@torch.no_grad()
def served_logits(a: MoEArch, seed: int, pairs: list, device, quant=None,
                  weights=None):
    """For each ``(prompt, served)`` pair: the reference's fp32 logits
    (len(served), vocab) at the positions that produced each served
    token."""
    seqs = [torch.cat([torch.as_tensor(p), torch.as_tensor(s)])[:-1]
            for p, s in pairs]
    xs = hidden_states(a, seed, seqs, device, quant, weights)
    ln = draw(a, seed, "final_ln", device, torch.float32)
    head = draw(a, seed, "embed" if a.tied else "head", device,
                torch.float32)[: a.V]
    if quant == "fp8":
        head = fp8_round(head)
    return [matmul(rmsnorm(x[len(p) - 1:], ln, a.eps), head.T, quant)
            for (p, _), x in zip(pairs, xs)]


@torch.no_grad()
def served_gaps(a: MoEArch, seed: int, pairs: list, device) -> list:
    """Per pair, the gaps of the served tokens under the fp32 reference."""
    exact_fp32()
    return [gaps(lg, torch.as_tensor(s)).cpu()
            for lg, (_, s) in zip(served_logits(a, seed, pairs, device),
                                  pairs)]


@torch.no_grad()
def control_gaps(a: MoEArch, seed: int, pairs: list, device) -> list:
    """Per pair, the gaps (under the fp32 reference) of the tokens the fp8
    control puts first at the same positions."""
    exact_fp32()
    ref = served_logits(a, seed, pairs, device)
    low = served_logits(a, seed, pairs, device, quant="fp8")
    return [gaps(r, l.argmax(-1)).cpu() for r, l in zip(ref, low)]
