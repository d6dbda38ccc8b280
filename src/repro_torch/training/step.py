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
    before the update."""
    decay = {n: d >= 2 for n, d in jax_leaf_ndims(model).items()}

    def grads_of(batch):
        for p in model.parameters():
            p.grad = None
        loss, metrics = model.loss_fn(batch)
        loss.backward()
        return ({n: p.grad for n, p in model.named_parameters()},
                loss.detach(), {k: v.detach() for k, v in metrics.items()})

    def accumulate(batch):
        # placed as the parameter (a DTensor's shards, on a mesh)
        acc = {n: torch.zeros_like(p, dtype=accum_dtype)
               for n, p in model.named_parameters()}
        losses, metricses = [], []
        for i in range(microbatches):
            grads, loss, metrics = grads_of({k: v[i] for k, v in
                                             batch.items()})
            for n, g in grads.items():
                acc[n] += g.to(accum_dtype)
            losses.append(loss)
            metricses.append(metrics)
        grads = {n: a / microbatches for n, a in acc.items()}
        metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                   for k in metricses[0]}
        return grads, torch.stack(losses).mean(), metrics

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = bind_params(model, state.params)
        if microbatches > 1:
            grads, loss, metrics = accumulate(batch)
        else:
            grads, loss, metrics = grads_of(batch)
        if compress_grads is not None:
            grads = compress_grads(grads)
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, grads, state.opt_state, params, decay)
        for p in model.parameters():
            p.grad = None
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step + 1), metrics

    return train_step
