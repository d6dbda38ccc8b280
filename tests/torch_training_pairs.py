"""Shared harness of the training parity tests: one seeded batch (numpy)
through the JAX package's ``LM.loss_fn`` and the port's, with the JAX
``LM.init`` weights carried across by ``params_from_jax``, fp32; the
gradients compared in the port's names (JAX's grads mapped through
``params_from_jax`` too), and one AdamW step of each package from the
same gradients."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro.training.optimizer import adamw_update as jax_adamw_update
from repro_torch.configs import get_config
from repro_torch.models import LM, jax_leaf_ndims, params_from_jax
from repro_torch.training import AdamWConfig, adamw_init, adamw_update

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL_OF_MAX = 1e-6, 1e-4
STEP_LR, STEP_ATOL = 1e-3, 1e-5


def batch_for(cfg, B, S, seed=0):
    """tokens/labels (B, S) from one seeded walk, and the frontend
    embeddings a VLM (its image patches) or an encoder-decoder (32 audio
    frames) needs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend.kind == "vision":
        batch["frontend_embeds"] = rng.standard_normal(
            (B, cfg.frontend.num_tokens, cfg.frontend.d_frontend)).astype(
                np.float32)
    if cfg.family == "encdec":
        batch["frontend_embeds"] = rng.standard_normal(
            (B, 32, cfg.d_model)).astype(np.float32)
    return batch


def jax_config(arch):
    """The JAX package's config of ``arch``; ``-noexperts`` is its
    DeepSeek-V2 without the experts, as the port registers it."""
    if "noexperts" in arch:
        return dataclasses.replace(
            jax_get_config(arch.replace("-noexperts", "")), name=arch,
            family="attn_dense", moe=None)
    return jax_get_config(arch)


def jax_run(arch, batch, chunk_size=512, seed=0):
    """JAX params, loss, metrics and grads (fp32, remat off)."""
    jmodel = build_model(jax_config(arch), remat=False,
                         chunk_size=chunk_size)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jmodel.loss_fn, has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return jparams, float(loss), float(metrics["aux_loss"]), grads


def port_model(arch, jparams, chunk_size=512, remat=False):
    cfg = get_config(arch)
    model = LM(cfg, device="cpu", chunk_size=chunk_size, remat=remat)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg))
    model.requires_grad_(True)
    return model


def port_run(model, batch):
    """The port's loss, aux and grads by name."""
    for p in model.parameters():
        p.grad = None
    loss, metrics = model.loss_fn({k: torch.from_numpy(np.array(v))
                                   for k, v in batch.items()})
    loss.backward()
    return (loss.detach().item(), metrics["aux_loss"].detach().item(),
            {n: p.grad.detach().clone() for n, p in model.named_parameters()})


def check_loss(jl, ja, tl, ta):
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)
    assert abs(ta - ja) <= LOSS_RTOL * max(abs(ja), 1e-30), (ta, ja)


def check_grads(cfg, jgrads, tgrads):
    """Every leaf: max |Δ| ≤ 1e-6 + 1e-4 · max |g|."""
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    assert set(want) == set(tgrads)
    for n, g in tgrads.items():
        ref = want[n]
        err = (g - ref).abs().max().item()
        assert err <= GRAD_ATOL + GRAD_RTOL_OF_MAX * ref.abs().max().item(), (
            n, err, ref.abs().max().item())


def check_adamw_step(cfg, model, jparams, jgrads):
    """One AdamW step at lr 1e-3 (no warmup) of each package from the same
    gradients (JAX's, carried into the port's names): the port's params
    within 1e-5 of JAX's. The same gradients, because Adam's first step is
    about ``lr · g / (|g| + eps)``: where ``|g · clip|`` is near ``eps``
    (1e-8) a gradient's last bits move the param by a fraction of ``lr``
    (``internlm2-1.8b-smoke``'s ``head[130, 73]``: 1.30e-8 here, 0.90e-8
    in JAX, within the gradient tolerance, moves it 7.4e-5)."""
    jcfg = JaxAdamWConfig(lr=STEP_LR, warmup_steps=1, total_steps=10)
    jnew, _, _ = jax.jit(functools.partial(jax_adamw_update, jcfg))(
        jgrads, jax_adamw_init(jparams), jparams)
    params = {n: p.detach() for n, p in model.named_parameters()}
    decay = {n: d >= 2 for n, d in jax_leaf_ndims(model).items()}
    grads = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    adamw_update(AdamWConfig(lr=STEP_LR, warmup_steps=1, total_steps=10),
                 grads, adamw_init(params), params, decay)
    want = params_from_jax(jax.tree.map(np.asarray, jnew), cfg)
    for n, p in params.items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(),
                                   atol=STEP_ATOL, err_msg=n)
