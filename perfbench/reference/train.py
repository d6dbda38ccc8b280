"""Plain training of the dense decoder: the loss, its gradients and AdamW.

The train cell's comparison. From the seed's weights (the bf16 draw
widened to fp32, as the program's fp32 masters start), it runs the
checked steps on the same batches in fp32 with TF32 off, each layer
recomputed in the backward (``torch.utils.checkpoint``) so that 4096-token
rows fit beside the optimizer's state. AdamW as published (Loshchilov and
Hutter) with the job's settings: global-norm clipping, bias-corrected
moments, decoupled decay on the leaves the job names, and a linear warmup
into a cosine to 10% of the base rate.

It returns what the cell compares: each step's loss, each leaf's norm of
the first step's (clipped) gradient, and each leaf's norm of its change
over the checked steps.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.decoder import exact_fp32, fp8_round, layer, rmsnorm
from perfbench.weights import Arch, draw, tensor_specs


def lr_at(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    if opt["schedule"] == "const":
        return opt["lr"] * warm
    if opt["schedule"] != "cosine":
        raise ValueError(f"schedule {opt['schedule']!r}")
    prog = min(max(step / max(opt["total_steps"], 1), 0.0), 1.0)
    return opt["lr"] * warm * (0.1 + 0.45 * (1.0 + math.cos(math.pi * prog)))


def loss_fn(a: Arch, p: dict, tokens, labels, quant=None):
    """Mean next-token NLL over every position of the batch."""
    table = p["embed"]
    head = (table if a.tied else p["head"])[: a.V]
    losses = []
    for b in range(tokens.shape[0]):
        x = table[tokens[b].long()]
        for i in range(a.L):
            w = {n[len(f"blocks.{i}."):]: t for n, t in p.items()
                 if n.startswith(f"blocks.{i}.")}
            x = checkpoint(layer, a, w, x, quant, use_reentrant=False)
        h = rmsnorm(x, p["final_ln"], a.eps)
        hw = fp8_round(head) if quant == "fp8" else head
        hx = fp8_round(h, dim=-1) if quant == "fp8" else h
        logits = hx @ hw.T
        losses.append(F.cross_entropy(logits, labels[b].long(),
                                      reduction="sum"))
    return torch.stack(losses).sum() / tokens.numel()


def train(a: Arch, seed: int, batches: list, opt: dict, device,
          quant=None) -> dict:
    """The checked steps over ``batches`` (dicts of (B, S) arrays)."""
    exact_fp32()
    names = [n for n, _, _ in tensor_specs(a)]
    p = {n: draw(a, seed, n, device, torch.float32).requires_grad_()
         for n in names}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    no_decay = set(opt.get("no_decay", ()))
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses, first = [], None
    for k, batch in enumerate(batches, start=1):
        tokens = torch.as_tensor(batch["tokens"], device=device)
        labels = torch.as_tensor(batch["labels"], device=device)
        loss = loss_fn(a, p, tokens, labels, quant)
        grads = torch.autograd.grad(loss, [p[n] for n in names])
        losses.append(float(loss.detach()))
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
        clip = torch.clamp_max(opt["grad_clip"] / (gnorm + 1e-9), 1.0)
        lr = lr_at(opt, k)
        with torch.no_grad():
            for n, g in zip(names, grads):
                g = g * clip
                if k == 1:
                    first = first or {}
                    first[n] = float(torch.linalg.vector_norm(g))
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                step = (m[n] / (1 - b1 ** k)) / (
                    torch.sqrt(v[n] / (1 - b2 ** k)) + eps)
                if n not in no_decay:
                    step = step + opt["weight_decay"] * p[n]
                p[n].sub_(lr * step)
        del grads
    change = {}
    with torch.no_grad():
        for n in names:
            change[n] = float(torch.linalg.vector_norm(
                p[n] - draw(a, seed, n, device, torch.float32)))
    return {"loss": losses, "grad": first, "change": change}


def gaps(prog: dict, ref: dict) -> dict:
    """The three numbers a train cell compares, each against its
    reference: the worst step's loss gap (relative), and the worst leaf's
    gap of the first gradient's norm and of the change's norm, each over
    the larger of that leaf's and the median leaf's reference norm. A leaf
    whose reference gradient is under a thousandth of the median leaf's
    moves by round-off alone and is left out of the change."""
    import statistics
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    med_g = statistics.median(ref["grad"].values())
    grad = max(abs(prog["grad"][n] - g) / max(g, med_g)
               for n, g in ref["grad"].items())
    moved = [n for n, g in ref["grad"].items() if g >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][n] for n in moved)
    change = max(abs(prog["change"][n] - ref["change"][n])
                 / max(ref["change"][n], med_c) for n in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}
