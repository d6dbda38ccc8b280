"""AdamW with fp32 master weights and WSD / cosine schedules.

The port's copy of the JAX package's ``training/optimizer.py``, on
mappings of tensors (parameter name → tensor). State::

    {"mu": moment_dtype like params, "nu": moment_dtype like params,
     "master": fp32 like params, "count": int32 scalar}

Every scalar of the update (the clip factor, the learning rate, the bias
corrections) is an fp32 tensor on the parameters' device, computed in the
reference's order of operations, so a step never waits on the host. The
update runs on the fp32 ``master``; the parameters are then set to
``master`` cast to their dtype, in place.

The WSD (warmup-stable-decay) schedule is the MiniCPM training schedule
[arXiv:2404.06395]: linear warmup → constant → short decay tail.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.distributed.sharding import placed_as, replicated


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"      # "cosine" | "wsd" | "const"
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1       # WSD: fraction of steps in the decay tail


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: AdamWConfig, step, device=None):
    """Schedule multiplier × base lr at ``step`` (an int or a tensor), as an
    fp32 scalar tensor."""
    step = _f32(step, device)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    if cfg.schedule == "const":
        return cfg.lr * warm
    if cfg.schedule == "wsd":
        decay_steps = max(int(cfg.total_steps * cfg.decay_frac), 1)
        decay_start = cfg.total_steps - decay_steps
        frac = torch.clamp((step - decay_start) / decay_steps, 0.0, 1.0)
        # exponential-ish decay tail to 10% (MiniCPM uses sqrt-style tails)
        tail = torch.pow(_f32(0.1, step.device), frac)
        return cfg.lr * warm * tail
    # cosine to 10 %
    prog = torch.clamp(step / max(cfg.total_steps, 1), 0.0, 1.0)
    # the cosine of the fp32 angle, rounded from fp64: XLA's fp32 cos is
    # the correctly rounded one where torch's may be an ulp off
    angle = _f32(math.pi, step.device) * prog
    cos = 0.1 + 0.45 * (1.0 + torch.cos(angle.double()).float())
    return cfg.lr * warm * cos


def adamw_init(params: dict, moment_dtype=torch.float32) -> dict:
    """Zero moments in ``moment_dtype`` (bf16 halves their memory), fp32
    masters copied from ``params`` (from bf16 params when the model
    computes in bf16, as the reference takes them), ``count`` 0."""
    dev = next(iter(params.values())).device
    return {
        "mu": {n: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
               for n, p in params.items()},
        "nu": {n: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
               for n, p in params.items()},
        "master": {n: p.detach().float().clone() for n, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: dict):
    """sqrt of the sum of every leaf's fp32 sum of squares (on a mesh,
    the ranks' partial sums added in one all-reduce)."""
    total = None
    for g in tree.values():
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(replicated(total))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, opt_state: dict,
                 params: dict, decay: dict | None = None):
    """One AdamW step. Returns ``(params, opt_state, {"grad_norm",
    "lr"})``: ``params`` are the same tensors, set in place to the new
    masters in their dtype; ``opt_state`` is a new mapping (``mu``, ``nu``
    and ``master`` updated in place, a new ``count``).

    ``decay`` maps a name to whether its leaf decays. The reference decays
    every leaf of rank 2 or more, which is the default here; a model whose
    layers the reference stacks passes the rank of the stacked leaf
    (``models.jax_leaf_ndims``)."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    lr = lr_at(cfg, count)
    countf = count.float()
    b1c = 1.0 - torch.pow(_f32(cfg.b1, count.device), countf)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, count.device), countf)
    for n, p in params.items():
        g = grads[n].float() * clip
        mu, nu, master = (opt_state[k][n] for k in ("mu", "nu", "master"))
        mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g
        nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * torch.square(g)
        step = (mu32 / b1c) / (torch.sqrt(nu32 / b2c) + cfg.eps)
        decays = master.ndim >= 2 if decay is None else decay[n]
        wd = cfg.weight_decay * master if decays else 0.0
        master.sub_(lr * (step + wd))
        mu.copy_(mu32)
        nu.copy_(nu32)
        p.copy_(placed_as(master, p))
    new_state = {"mu": opt_state["mu"], "nu": opt_state["nu"],
                 "master": opt_state["master"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
