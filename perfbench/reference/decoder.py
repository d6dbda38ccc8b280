"""A dense GQA decoder in plain PyTorch, run a layer at a time.

``served_gaps`` is the serving cells' comparison: it runs every sampled
sequence (a prompt followed by the tokens the program served for it)
through the model, one layer at a time over all sequences, drawing each
layer's weights again from the seed, so that a 16 B model in fp32 needs
one layer of weights at once. At each served position it reads the
reference's best logit and the served token's: the gap is how far the
served token lies below the best.

``quant="fp8"`` is the control: every matrix product takes its weight and
its input rounded to float8 e4m3 (a scale a weight tensor, a scale a row
of activations), and the gap read is that of the token the fp8 model puts
first, measured by the fp32 model.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.weights import Arch, draw, draw_layer

FP8_MAX = 448.0                 # float8 e4m3's largest finite value


def exact_fp32() -> None:
    """No TF32 anywhere: the reference's products are true fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under an absmax scale (over the whole
    tensor, or over each slice along ``dim``), returned in fp32; under
    autograd the rounding passes the gradient straight through."""
    with torch.no_grad():
        amax = (x.abs().amax() if dim is None
                else x.abs().amax(dim=dim, keepdim=True)).clamp_min(1e-12)
        scale = FP8_MAX / amax
        q = (x * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


def matmul(x, w, quant=None):
    if quant == "fp8":
        return fp8_round(x, dim=-1) @ w
    return x @ w


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """Half-split rotary embedding; x (S, heads, D), pos (S,)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = pos.double()[:, None] * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(q, k, v, block: int = 512):
    """Causal grouped-query attention of one sequence: q (S, H, D), k and
    v (S, K, D); query head ``h`` reads key/value head ``h // (H / K)``.
    Queries in blocks, so the scores of one block are held at once."""
    S, H, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)          # (H, S, D)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = []
    keys = torch.arange(S, device=q.device)
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        qb = q[s0:s1].transpose(0, 1)                         # (H, b, D)
        sc = (qb @ k[:, :s1].transpose(1, 2)) / math.sqrt(D)
        mask = keys[None, :s1] > torch.arange(s0, s1, device=q.device)[:, None]
        sc = sc.masked_fill(mask, float("-inf"))
        out.append((torch.softmax(sc, -1) @ v[:, :s1]).transpose(0, 1))
    return torch.cat(out)


def layer(a: Arch, w: dict, x, quant=None):
    """One pre-norm decoder layer over one sequence x (S, d)."""
    if quant == "fp8":
        w = {n: (t if t.ndim == 1 else fp8_round(t)) for n, t in w.items()}
    S = x.shape[0]
    pos = torch.arange(S, device=x.device)
    h = rmsnorm(x, w["ln_attn"], a.eps)
    q = rope(matmul(h, w["wq"], quant).view(S, a.H, a.D), pos, a.theta)
    k = rope(matmul(h, w["wk"], quant).view(S, a.K, a.D), pos, a.theta)
    v = matmul(h, w["wv"], quant).view(S, a.K, a.D)
    x = x + matmul(attention(q, k, v).reshape(S, a.H * a.D), w["wo"], quant)
    h = rmsnorm(x, w["ln_ffn"], a.eps)
    if a.gated:
        f = F.silu(matmul(h, w["w_gate"], quant)) * matmul(h, w["w_up"], quant)
    else:
        f = F.gelu(matmul(h, w["w_up"], quant), approximate="tanh")
    return x + matmul(f, w["w_down"], quant)


@torch.no_grad()
def hidden_states(a: Arch, seed: int, seqs: list, device, quant=None,
                  weights=None):
    """The final hidden states (before the last norm) of each token
    sequence in ``seqs`` (1-D int tensors), a layer at a time over all of
    them. ``weights(layer)`` overrides the draw from the seed (tests)."""
    table = draw(a, seed, "embed", device, torch.float32)
    xs = [table[s.to(device).long()] for s in seqs]
    del table
    for i in range(a.L):
        w = (weights(i) if weights is not None
             else draw_layer(a, seed, i, device, torch.float32))
        xs = [layer(a, w, x, quant) for x in xs]
        del w
    return xs


@torch.no_grad()
def served_logits(a: Arch, seed: int, pairs: list, device, quant=None):
    """For each ``(prompt, served)`` pair: the reference's fp32 logits
    (len(served), vocab) at the positions that produced each served
    token."""
    seqs = [torch.cat([torch.as_tensor(p), torch.as_tensor(s)])[:-1]
            for p, s in pairs]
    xs = hidden_states(a, seed, seqs, device, quant)
    ln = draw(a, seed, "final_ln", device, torch.float32)
    head = draw(a, seed, "embed" if a.tied else "head", device,
                torch.float32)[: a.V]
    if quant == "fp8":
        head = fp8_round(head)
    out = []
    for (p, s), x in zip(pairs, xs):
        h = rmsnorm(x[len(p) - 1:], ln, a.eps)
        out.append(matmul(h, head.T, quant))
    return out


def gaps(logits, tokens) -> torch.Tensor:
    """How far each token's logit lies below its row's best."""
    tokens = torch.as_tensor(tokens, device=logits.device).long()
    return logits.amax(-1) - logits.gather(-1, tokens[:, None])[:, 0]


@torch.no_grad()
def served_gaps(a: Arch, seed: int, pairs: list, device) -> list:
    """Per pair, the gaps of the served tokens under the fp32 reference."""
    exact_fp32()
    return [gaps(lg, torch.as_tensor(s)).cpu()
            for lg, (_, s) in zip(served_logits(a, seed, pairs, device),
                                  pairs)]


@torch.no_grad()
def control_gaps(a: Arch, seed: int, pairs: list, device) -> list:
    """Per pair, the gaps (under the fp32 reference) of the tokens the fp8
    control puts first at the same positions."""
    exact_fp32()
    ref = served_logits(a, seed, pairs, device)
    low = served_logits(a, seed, pairs, device, quant="fp8")
    return [gaps(r, l.argmax(-1)).cpu() for r, l in zip(ref, low)]
