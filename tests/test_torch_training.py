"""``LM.loss_fn`` of the port against the JAX package's, for the smoke
config of every dense GQA arch, on the CPU: the loss
and the MoE aux within 1e-5 relative, every gradient within 1e-6 + 1e-4 ·
max |g| (mapped into the port's names through ``params_from_jax``), and
one AdamW step at lr 1e-3 from the same gradients within 1e-5 (see
``torch_training_pairs.check_adamw_step``) — the rank-based weight decay
included (a per-layer norm scale decays as the JAX stacked leaf does,
``final_ln`` does not). Remat recomputes and changes no value. The MoE
configs are in ``test_torch_training_moe.py``, the other families
(encoder-decoder, VLM, SSM, hybrid) in ``test_torch_training_families.py``,
the sequences past ``chunk_size`` and the attention Function in
``test_torch_training_long.py``."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model
from repro.training import init_train_state as jax_init_train_state
from repro_torch.configs import get_config
from repro_torch.models import LM, jax_leaf_ndims, params_from_jax
from repro_torch.training import adamw_init, init_train_state

from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)
from torch_training_pairs import (batch_for, check_adamw_step, check_grads,
                                  check_loss, jax_run, port_model, port_run)

ARCHS = ["internlm2-1.8b-smoke", "starcoder2-15b-smoke", "minicpm-2b-smoke",
         "gemma-7b-smoke"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_one_adamw_step_match_jax(arch):
    cfg = get_config(arch)
    batch = batch_for(cfg, 2, 64)
    jparams, jl, ja, jgrads = jax_run(arch, batch)
    model = port_model(arch, jparams)
    tl, ta, tgrads = port_run(model, batch)
    check_loss(jl, ja, tl, ta)
    if cfg.moe is not None:
        assert ta > 0
    check_grads(cfg, jgrads, tgrads)
    check_adamw_step(cfg, model, jparams, jgrads)


@pytest.mark.parametrize("arch", ["internlm2-1.8b-smoke",
                                  "deepseek-v2-236b-smoke"])
def test_remat_changes_no_value(arch):
    """The checkpointed loss path gives the same loss and gradients as the
    plain one, bit for bit."""
    cfg = get_config(arch)
    batch = batch_for(cfg, 2, 32, seed=1)
    model = LM(cfg, device="cpu", remat=False).init(
        torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    plain = port_run(model, batch)
    model.remat = True
    again = port_run(model, batch)
    assert plain[:2] == again[:2]
    for n, g in plain[2].items():
        assert torch.equal(g, again[2][n]), n


@pytest.mark.parametrize("arch", ["zamba2-1.2b-smoke",
                                  "seamless-m4t-large-v2-smoke",
                                  "deepseek-v2-236b-smoke",
                                  "llava-next-mistral-7b-smoke"])
def test_weight_decay_follows_the_jax_leaf_rank(arch):
    """``jax_leaf_ndims`` gives each port tensor the rank of the JAX leaf
    it comes from: a JAX tree filled with each leaf's rank, split by
    ``params_from_jax``, reads the same."""
    cfg = get_config(arch)
    jparams = build_model(jax_get_config(arch), remat=False).init(
        jax.random.PRNGKey(0))
    ranks = params_from_jax(jax.tree.map(
        lambda a: np.full(a.shape, a.ndim, np.int64), jparams), cfg)
    model = LM(cfg, device="cpu")
    got = jax_leaf_ndims(model)
    assert set(got) == set(ranks)
    for n, r in ranks.items():
        assert bool((r == got[n]).all()), (n, got[n])
    assert got["final_ln"] == 1
    if cfg.family == "hybrid":
        assert got["blocks.0.ln"] == 3          # mamba_seg: (n_seg, seg_len)
        assert got["blocks.0.a_log"] == 3
    else:
        assert got["blocks.0." + ("ln_self" if cfg.family == "encdec"
                                  else "ln_attn")] == 2


def test_bf16_masters_come_from_bf16_params():
    """With a bf16 compute dtype the fp32 masters are the bf16 params
    upcast, as the JAX ``init_train_state`` casts its params to bf16 before
    ``adamw_init``: the same weights give the same masters, bit for
    bit."""
    arch = "internlm2-1.8b-smoke"
    cfg = get_config(arch)
    jmodel = build_model(jax_get_config(arch), remat=False,
                         compute_dtype=jax.numpy.bfloat16)
    jstate = jax_init_train_state(jmodel, jax.random.PRNGKey(0))
    want = params_from_jax(jax.tree.map(np.asarray,
                                        jstate.opt_state["master"]), cfg)
    model = LM(cfg, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0))), cfg))
    master = adamw_init(dict(model.named_parameters()))["master"]
    assert set(master) == set(want)
    for n, m in master.items():
        assert m.dtype == want[n].dtype == torch.float32
        assert torch.equal(m, want[n]), n
    # init_train_state draws the weights in bf16 and takes the same route
    state = init_train_state(model, torch.Generator().manual_seed(0))
    for n, p in model.named_parameters():
        assert p.dtype == torch.bfloat16 and p.requires_grad
        assert torch.equal(state.opt_state["master"][n], p.float()), n
