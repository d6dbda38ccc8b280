"""Fake-tensor stand-ins for every model input (no device allocation).

The port's copy of the JAX package's ``launch/specs.py``. Every function
here builds tensors under the caller's ``FakeTensorMode`` — shapes,
dtypes and the run's device, no storage — where the reference builds
``ShapeDtypeStruct``s. ``input_specs(cfg, shape)`` → batch dict;
``abstract_params`` / ``abstract_state`` / ``abstract_cache`` give the
model's parameters, its train state and its decode cache (the cache by
running the model's own ``prefill`` on a fake prompt, so the dry run
steps exactly what the runtime steps); ``with_shardings`` makes DTensors
of them by the rules of :mod:`repro_torch.distributed.sharding`.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed.sharding import (P, distribute, param_specs,
                                              zero1_specs)
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.step import TrainState

ENC_FRAMES = 4096          # stub audio frontend length for enc-dec shapes


def input_specs(cfg: ModelConfig, shape: InputShape, dtype=torch.bfloat16,
                microbatches: int = 1, device="cuda") -> dict:
    """Tensors for one batch of this (arch × input-shape) cell: int32
    ``tokens`` and ``labels`` (decode: one new token a row against an
    S-token cache), and the VLM's image patches or the encoder-decoder's
    frames. With microbatches > 1 (training), leaves are (mb, B/mb, ...)."""
    B, S = shape.global_batch, shape.seq_len

    def leaf(s, dt):
        if microbatches > 1:
            s = (microbatches, s[0] // microbatches) + s[1:]
        return torch.empty(s, dtype=dt, device=device)

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": leaf((B, S), torch.int32),
                 "labels": leaf((B, S), torch.int32)}
    else:  # decode: one new token against an S-token cache
        batch = {"tokens": leaf((B, 1), torch.int32)}
    if cfg.frontend.kind == "vision" and shape.kind != "decode":
        batch["frontend_embeds"] = leaf(
            (B, cfg.frontend.num_tokens, cfg.frontend.d_frontend), dtype)
    if cfg.family == "encdec" and shape.kind != "decode":
        batch["frontend_embeds"] = leaf((B, ENC_FRAMES, cfg.d_model), dtype)
    return batch


def prefill_batch_for_cache(cfg: ModelConfig, shape: InputShape,
                            dtype=torch.bfloat16, device="cuda") -> dict:
    """The prompt used to derive decode-cache shapes."""
    B = shape.global_batch
    prompt = min(128, shape.seq_len)
    batch = {"tokens": torch.empty((B, prompt), dtype=torch.int32,
                                   device=device)}
    if cfg.frontend.kind == "vision":
        batch["frontend_embeds"] = torch.empty(
            (B, cfg.frontend.num_tokens, cfg.frontend.d_frontend),
            dtype=dtype, device=device)
    if cfg.family == "encdec":
        batch["frontend_embeds"] = torch.empty(
            (B, ENC_FRAMES, cfg.d_model), dtype=dtype, device=device)
    return batch


def abstract_params(model) -> dict:
    return dict(model.named_parameters())


def abstract_state(model, moment_dtype=torch.float32) -> TrainState:
    """The train state (params + AdamW state) of ``model``: its own
    parameters, with grad on, and fresh moments and masters."""
    model.requires_grad_(True)
    params = abstract_params(model)
    return TrainState(params=params,
                      opt_state=adamw_init(params, moment_dtype),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def abstract_cache(model, cfg, shape: InputShape, dtype=torch.bfloat16):
    """Decode-cache tensors for this cell from the model's ``prefill``."""
    batch = prefill_batch_for_cache(cfg, shape, dtype, model.device)
    _, cache = model.prefill(batch["tokens"], shape.seq_len,
                             frontend_embeds=batch.get("frontend_embeds"))
    return cache


def with_shardings(tree, spec_tree, mesh):
    """DTensors of a (nested dict) tree of tensors by a spec tree of the
    same structure (:func:`~repro_torch.distributed.sharding.distribute`)."""
    return distribute(tree, spec_tree, mesh)


def state_specs(state: TrainState, model, mesh) -> TrainState:
    """Specs of a TrainState: the params' own, ZeRO-1's for the AdamW
    state."""
    z = zero1_specs(model, mesh)
    return TrainState(
        params=param_specs(model, mesh),
        opt_state={"mu": z, "nu": z, "master": z, "count": P()},
        step=P(),
    )


def install_params(model, params: dict, requires_grad: bool) -> dict:
    """Make ``params`` (name → tensor, DTensors) ``model``'s parameters;
    returns them by name, as the model now holds them."""
    from torch import nn
    for name, t in params.items():
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path)) if path else model
        setattr(owner, leaf, nn.Parameter(t, requires_grad=requires_grad))
    return dict(model.named_parameters())
