"""The plain reference against the port's LM at the smoke widths, on the
CPU, in fp32: prefill logits of every position, and one train step's loss,
first gradient and update."""
import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.data import SyntheticLM
from perfbench.loops.serving import build_model
from perfbench.loops.train import _program_step
from perfbench.reference import decoder, train
from perfbench.tests.tiny import cell

CELLS = [("internlm2-chat-closed64", 2), ("internlm2-chat-closed64", 4),
         ("starcoder2-code-poisson", 2), ("starcoder2-code-poisson", 4)]


def fp32_cell(name, kv):
    c = cell(name, kv)
    c.config["torch_dtype"] = "float32"
    return c


@pytest.mark.parametrize("name,kv", CELLS)
def test_reference_logits_are_the_port_s(name, kv):
    c = fp32_cell(name, kv)
    a = weights.Arch(c.config)
    cpu = torch.device("cpu")
    model = build_model(c, 5, cpu)
    prompt = np.random.default_rng(0).integers(0, a.V, 40).astype(np.int64)
    served = np.random.default_rng(1).integers(0, a.V, 7)
    seq = np.concatenate([prompt, served])
    # the port's full-sequence logits at every position of prompt+served
    h = model._embed_tokens(torch.as_tensor(seq[None, :-1]))
    pos = torch.arange(len(seq) - 1)[None]
    from repro_torch.models import blocks as B
    with torch.no_grad():
        for blk in model.blocks:
            h, _ = B.apply_decoder_block(blk, model.cfg, h, pos)
        want = model._logits(h, None)[0, len(prompt) - 1:, : a.V]
    got = decoder.served_logits(a, 5, [(prompt, served)], cpu)[0]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    g = decoder.served_gaps(a, 5, [(prompt, served)], cpu)[0]
    np.testing.assert_allclose(
        g.numpy(), (want.amax(-1) - want[torch.arange(7), served]).numpy(),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,kv", CELLS[:3])
def test_reference_train_step_is_the_port_s(name, kv):
    c = fp32_cell(name, kv)
    a = weights.Arch(c.config)
    cpu = torch.device("cpu")
    opt = dict(c.traffic.get("optimizer") or
               {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                "weight_decay": 0.1, "grad_clip": 1.0, "schedule": "cosine",
                "warmup_steps": 100, "total_steps": 10000,
                "no_decay": ["final_ln"]})
    data = SyntheticLM(a.V, 24, 2, 9)
    batches = [data.batch(k) for k in range(2)]
    model = build_model(c, 9, cpu)
    state, step = _program_step(model, opt)
    prog = {"loss": [], "grad": {}, "change": {}}
    for k, b in enumerate(batches):
        state, m = step(state, b)
        prog["loss"].append(float(m["loss"]))
        if k == 0:
            prog["grad"] = {n: float(mu.norm()) / (1 - opt["b1"])
                            for n, mu in state.opt_state["mu"].items()}
    prog["change"] = {n: float((w - weights.draw(a, 9, n, cpu,
                                                 torch.float32)).norm())
                      for n, w in state.opt_state["master"].items()}
    ref = train.train(a, 9, batches, opt, cpu)
    gaps = train.gaps(prog, ref)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-4


def test_a_configuration_runs_as_its_departures_state():
    from perfbench.tests.tiny import smoke_config
    from perfbench.weights import Arch
    c = smoke_config("starcoder2-15b", kv_heads=2)
    assert c["use_bias"] and c["norm_type"] == "layer_norm"
    Arch(c)                                  # the departures make it runnable
    for key in ("use_bias", "norm_type"):
        published = dict(c, departures={k: v for k, v in
                                        c["departures"].items() if k != key})
        with pytest.raises(ValueError, match=key):
            Arch(published)
