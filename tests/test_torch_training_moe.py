"""``LM.loss_fn`` of the port against the JAX package's for the MoE smoke
configs — DeepSeek-V2 (MLA, shared experts, a first dense layer) and
Arctic (a dense FFN beside the experts) — at their own capacity factor
(1.25), on the CPU: the loss and the router aux loss within 1e-5
relative, every gradient within 1e-6 + 1e-4 · max |g|, one AdamW step at
lr 1e-3 within 1e-5 (``torch_training_pairs``)."""
import pytest

from repro_torch.configs import get_config

from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)
from torch_training_pairs import (batch_for, check_adamw_step, check_grads,
                                  check_loss, jax_run, port_model, port_run)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b-smoke",
                                  "arctic-480b-smoke"])
def test_moe_loss_grads_and_one_adamw_step_match_jax(arch):
    cfg = get_config(arch)
    assert cfg.moe.capacity_factor == 1.25
    batch = batch_for(cfg, 2, 64)
    jparams, jl, ja, jgrads = jax_run(arch, batch)
    model = port_model(arch, jparams)
    tl, ta, tgrads = port_run(model, batch)
    assert ta > 0
    check_loss(jl, ja, tl, ta)
    check_grads(cfg, jgrads, tgrads)
    check_adamw_step(cfg, model, jparams, jgrads)
