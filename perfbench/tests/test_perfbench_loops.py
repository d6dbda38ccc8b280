"""Each loop kind at smoke size on the CPU, through the same loop code as
on the card (the card's check is skipped: ``run_cell`` is given the CPU),
and the faults each cell can have, planted underneath the timed path:
each has to come out not correct."""
import time

import pytest
import torch

from perfbench import bench
from perfbench.tests.tiny import cell

CPU = torch.device("cpu")
CELLS = ["internlm2-chat-closed64", "starcoder2-code-poisson",
         "internlm2-train-4k"]


def run(name, trace=False, seconds=3.0):
    return bench.run_cell(cell(name), 2 ** 31 + 77, seconds, trace, CPU,
                          time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_loop_runs_and_is_correct(name, trace):
    res, out = run(name, trace)
    c = cell(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(c.limits)
    if trace:
        assert res["device"]["window_s"] > 0
        assert {"device_ops", "idle_gaps"} <= set(res["breakdown"])
    else:
        assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    parts = out.setup_parts
    assert {"imports", "libraries", "weights"} <= set(parts)


def _alter_tokens(monkeypatch):
    from repro_torch.serving.scheduler import Scheduler
    plan = Scheduler._plan_decode

    def altered(self, r, k):
        nxt, drafts = plan(self, r, k)
        return (nxt + 1) % self.engine.model.cfg.vocab_size, drafts
    monkeypatch.setattr(Scheduler, "_plan_decode", altered)


def _pool_unchanged(monkeypatch):
    """The KV pool left as it was: neither a prompt's pages nor a tick's
    new tokens are written."""
    from repro_torch.models import attention
    from repro_torch.serving import batching
    monkeypatch.setattr(attention, "_scatter_pool", lambda *a, **k: None)
    monkeypatch.setattr(batching, "scatter_prefill_planes",
                        lambda pools, *a, **k: pools)


def _state_unchanged(monkeypatch):
    from repro_torch.training import step as step_mod

    def no_update(cfg, grads, opt_state, params, decay=None):
        return params, opt_state, {"grad_norm": torch.zeros(()),
                                   "lr": torch.zeros(())}
    monkeypatch.setattr(step_mod, "adamw_update", no_update)


def _half_batch(monkeypatch):
    from repro_torch.models.model import LM
    loss_fn = LM.loss_fn

    def half(self, batch):
        return loss_fn(self, {k: v[: len(v) // 2] for k, v in batch.items()})
    monkeypatch.setattr(LM, "loss_fn", half)


FAULTS = [("internlm2-chat-closed64", _alter_tokens),
          ("internlm2-chat-closed64", _pool_unchanged),
          ("starcoder2-code-poisson", _alter_tokens),
          ("starcoder2-code-poisson", _pool_unchanged),
          ("internlm2-train-4k", _state_unchanged),
          ("internlm2-train-4k", _half_batch)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res, _ = run(name)
    assert not res["correct"], res["checks"]
