"""The train step: loss → grads → (optionally compressed) update.

The port's counterpart of the JAX package's ``training/step.py``. The
state is a :class:`TrainState` of plain tensors — ``params`` (name →
the model's own parameter tensors), ``opt_state`` (AdamW's ``mu``,
``nu``, fp32 ``master`` and ``count``) and ``step`` — so
``CheckpointManager`` saves it as it is and restores it into a state
shaped like it. Where the reference's step is a pure function of the
state, this one updates the model's parameters and the optimizer state in
place and returns the state: a state restored from a checkpoint is bound
into the model (its tensors become the parameters' storage) on the next
step.

Microbatching (grad accumulation) is a Python loop over the leading
``microbatches`` axis of the batch's leaves, accumulating in
``accum_dtype`` and dividing by the count, as the reference's scan does.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import telemetry
from repro_torch.distributed.sharding import is_dtensor, placed_as
from repro_torch.models.model import jax_leaf_ndims
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)


class TrainState(dict):
    """``params``, ``opt_state`` and ``step``: a dict of those three names
    (the tree ``CheckpointManager`` saves, and rebuilds on ``restore``),
    each also read as an attribute."""

    params = property(lambda self: self["params"])
    opt_state = property(lambda self: self["opt_state"])
    step = property(lambda self: self["step"])


def init_train_state(model, generator: torch.Generator) -> TrainState:
    """Draw ``model``'s weights from ``generator`` (in its compute dtype: a
    bf16 model's fp32 masters are taken from its bf16 weights, as the
    reference casts its params before ``adamw_init``), turn their grad on,
    and start AdamW at step 0."""
    model.init(generator)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return TrainState(params=params, opt_state=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def bind_params(model, params: dict) -> dict:
    """Make ``params``' tensors the storage of ``model``'s parameters (a
    state restored from a checkpoint); returns the model's parameters by
    name."""
    own = dict(model.named_parameters())
    for n, p in own.items():
        t = params[n]
        if t is not p and t.data_ptr() != p.data_ptr():
            if t.shape != p.shape or t.dtype != p.dtype \
                    or t.device != p.device:
                raise ValueError(f"{n}: {t.dtype}{list(t.shape)} on "
                                 f"{t.device} cannot back the parameter "
                                 f"{p.dtype}{list(p.shape)} on {p.device}")
            p.data = t.detach()
    return own


def make_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    accum_dtype=torch.float32,
                    compress_grads: Optional[Callable] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``, metrics
    ``{"loss", "aux_loss", "grad_norm", "lr"}`` as tensors. ``batch`` is a
    dict of arrays; with ``microbatches > 1`` its leaves are ``(mb, B/mb,
    ...)``. ``accum_dtype`` is the gradient accumulator's dtype (bf16
    halves it). ``compress_grads`` maps the gradients (name → tensor)
    before the update. Under a profiler a step is a
    ``repro_torch.train.step`` range holding its forward, backward and
    optimizer ranges (:mod:`repro_torch.telemetry`)."""
    decay = {n: d >= 2 for n, d in jax_leaf_ndims(model).items()}

    def grads_of(batch):
        # taken as the backward hands them over: a parameter's .grad would
        # be laid out as the parameter on one torch release and not on
        # another (on a mesh), and the train step places them itself
        with telemetry.span(telemetry.TRAIN_FORWARD):
            loss, metrics = model.loss_fn(batch)
        named = dict(model.named_parameters())
        live = [n for n, p in named.items() if p.requires_grad]
        grads = dict.fromkeys(named)
        with telemetry.span(telemetry.TRAIN_BACKWARD):
            grads.update(zip(live, torch.autograd.grad(
                loss, [named[n] for n in live], allow_unused=True)))
        return (grads, loss.detach(),
                {k: v.detach() for k, v in metrics.items()})

    def accumulate(batch, mu):
        # placed as the optimizer state (a DTensor's ZeRO-1 shards, on a
        # mesh)
        acc = {n: torch.zeros_like(mu[n], dtype=accum_dtype)
               for n, _ in model.named_parameters()}
        losses, metricses = [], []
        for i in range(microbatches):
            grads, loss, metrics = grads_of({k: v[i] for k, v in
                                             batch.items()})
            for n, g in grads.items():
                acc[n] += reduced(g, acc[n]).to(accum_dtype)
            losses.append(loss)
            metricses.append(metrics)
        grads = {n: a / microbatches for n, a in acc.items()}
        metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                   for k in metricses[0]}
        return grads, torch.stack(losses).mean(), metrics

    def reduced(g, like):
        """A gradient on a mesh — Partial over the ranks that split the
        batch — summed once into ``like``'s layout (the optimizer
        state's: a reduce-scatter onto its ZeRO-1 shard), where each of
        the optimizer's ops would reduce it anew; summed in its own dtype
        (bf16 for a bf16 model, as the reference's GSPMD sums it), then
        cast to ``accum_dtype``. A plain tensor as it is."""
        return placed_as(g, like).to(accum_dtype) if is_dtensor(g) else g

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        with telemetry.span(telemetry.TRAIN_STEP):
            return step(state, batch)

    def step(state, batch):
        params = bind_params(model, state.params)
        mu = state.opt_state["mu"]
        if microbatches > 1:
            grads, loss, metrics = accumulate(batch, mu)
        else:
            grads, loss, metrics = grads_of(batch)
            grads = {n: reduced(g, mu[n]) for n, g in grads.items()}
        if compress_grads is not None:
            grads = compress_grads(grads)
        with telemetry.span(telemetry.TRAIN_OPTIMIZER):
            params, opt_state, opt_metrics = adamw_update(
                opt_cfg, grads, state.opt_state, params, decay)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step + 1), metrics

    return train_step
