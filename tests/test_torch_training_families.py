"""``LM.loss_fn`` of the port against the JAX package's for the families
beyond the decoder: the encoder-decoder (Seamless-M4T v2: the encoder over
32 audio frames, then the decoder with cross-attention), the VLM
(LLaVA-NeXT: the projected image patches first, the loss on the text
positions only), Mamba-2 (the SSD chunk scan) and the Zamba2 hybrid
(checkpointed a segment at a time), smoke configs on the CPU: the loss
within 1e-5 relative, every gradient within 1e-6 + 1e-4 · max |g|, one
AdamW step at lr 1e-3 within 1e-5 — the SSM's ``a_log``, ``d_skip``,
``dt_bias``, ``conv_b`` and ``norm_scale`` decay as their stacked JAX
leaves do (``torch_training_pairs``). A loss mask is held to JAX too."""
import numpy as np
import pytest

from repro_torch.configs import get_config

from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)
from torch_training_pairs import (batch_for, check_adamw_step, check_grads,
                                  check_loss, jax_run, port_model, port_run)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2-smoke",
                                  "llava-next-mistral-7b-smoke",
                                  "mamba2-1.3b-smoke", "zamba2-1.2b-smoke"])
def test_family_loss_grads_and_one_adamw_step_match_jax(arch):
    cfg = get_config(arch)
    batch = batch_for(cfg, 2, 64)
    jparams, jl, ja, jgrads = jax_run(arch, batch)
    model = port_model(arch, jparams, remat=True)
    tl, ta, tgrads = port_run(model, batch)
    check_loss(jl, ja, tl, ta)
    check_grads(cfg, jgrads, tgrads)
    check_adamw_step(cfg, model, jparams, jgrads)


def test_loss_mask_matches_jax():
    arch = "internlm2-1.8b-smoke"
    cfg = get_config(arch)
    batch = batch_for(cfg, 2, 32, seed=3)
    batch["loss_mask"] = (np.random.default_rng(4).random((2, 32))
                          < 0.6).astype(np.int32)
    jparams, jl, ja, jgrads = jax_run(arch, batch)
    model = port_model(arch, jparams)
    tl, ta, tgrads = port_run(model, batch)
    check_loss(jl, ja, tl, ta)
    check_grads(cfg, jgrads, tgrads)
