"""The port's training substrate on the CPU, against the JAX package's:
the ports of ``tests/test_training.py`` (the loss decreases on
``internlm2-1.8b-smoke``, the WSD and cosine shapes, microbatch 2 equal
to one batch, int8 compression and error feedback), ``lr_at`` equal to
JAX's at every step of each schedule, compression codes and scales equal
to JAX's bit for bit, the ports of ``tests/test_data.py`` (each batch
equal to the reference's bit for bit) and ``tests/test_elastic.py``, the
training CLI, and the example's crash and bit-exact resume through
NVLog at a small width."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLMDataset as JaxDataset
from repro.data import make_batch_iterator as jax_batch_iterator
from repro.distributed.compression import quantize_int8 as jax_quantize
from repro.training import AdamWConfig as JaxAdamWConfig
from repro.training import lr_at as jax_lr_at
from repro.training.elastic import StragglerPolicy as JaxStragglerPolicy
from repro.training.elastic import MeshPlan as JaxMeshPlan
from repro.training.elastic import replan_mesh as jax_replan_mesh
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset, make_batch_iterator
from repro_torch.distributed.compression import (
    dequantize_int8, make_error_feedback_compressor, quantize_int8)
from repro_torch.launch import train as train_cli
from repro_torch.models import LM
from repro_torch.training import (AdamWConfig, init_train_state, lr_at,
                                  make_train_step)
from repro_torch.training.elastic import (MeshPlan, StragglerPolicy,
                                          replan_mesh)

from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _state(cfg, seed=0, **kw):
    model = LM(cfg, device="cpu", remat=False, **kw)
    return model, init_train_state(model, torch.Generator().manual_seed(seed))


# ------------------------------------------------------- test_training.py
def test_loss_decreases_internlm_smoke():
    cfg = get_config("internlm2-1.8b-smoke")
    model, state = _state(cfg)
    step_fn = make_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=5,
                                                 total_steps=60))
    ds = SyntheticLMDataset(cfg.vocab_size, 128, 8, seed=0)
    it = make_batch_iterator(ds)
    losses = []
    for _ in range(60):
        state, metrics = step_fn(state, next(it))
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < 0.75 * np.mean(losses[:5])
    assert np.mean(losses[-5:]) > ds.entropy_floor - 0.05
    assert int(state.step) == 60 and int(state.opt_state["count"]) == 60


def test_wsd_schedule_shape():
    cfg = AdamWConfig(lr=1.0, schedule="wsd", warmup_steps=10,
                      total_steps=100, decay_frac=0.2)
    lrs = [float(lr_at(cfg, s)) for s in range(101)]
    assert lrs[0] < 0.2                     # warmup start
    assert lrs[10] == pytest.approx(1.0)    # warmup done
    assert lrs[50] == pytest.approx(1.0)    # stable plateau
    assert lrs[79] == pytest.approx(1.0)    # last stable step
    assert lrs[100] == pytest.approx(0.1, rel=0.05)   # decayed tail
    assert all(a >= b - 1e-9 for a, b in zip(lrs[10:], lrs[11:]))


def test_cosine_schedule_monotone_after_warmup():
    cfg = AdamWConfig(lr=1.0, schedule="cosine", warmup_steps=5,
                      total_steps=50)
    lrs = [float(lr_at(cfg, s)) for s in range(51)]
    assert lrs[5] == pytest.approx(1.0, rel=0.05)
    assert lrs[50] == pytest.approx(0.1, rel=0.05)
    assert all(a >= b - 1e-9 for a, b in zip(lrs[5:], lrs[6:]))


@pytest.mark.parametrize("total", [90, 10_000])
@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_lr_at_is_jax_lr_at_at_every_step(schedule, total):
    """Every step of the schedule, fp32: within 2 ulp of JAX's (XLA's fp32
    ``cos`` and ``pow`` and torch's differ in the last bits at some
    arguments: 54 of the 10,002 cosine steps and 10 of the WSD ones), and
    equal at every step of the 90-step schedules."""
    kw = dict(lr=3e-3, schedule=schedule, warmup_steps=7 if total < 100
              else 100, total_steps=total, decay_frac=0.2)
    steps = np.arange(total + 2, dtype=np.int32)
    got = lr_at(AdamWConfig(**kw), torch.from_numpy(steps))
    assert got.dtype == torch.float32
    want = np.asarray(jax_lr_at(JaxAdamWConfig(**kw), jnp.asarray(steps)))
    ulps = np.abs(got.numpy().view(np.int32) - want.view(np.int32))
    assert ulps.max() <= 2
    if total < 100:
        assert not ulps.any()
    one = lr_at(AdamWConfig(**kw), torch.tensor(total // 3,
                                                dtype=torch.int32))
    assert one.item() == float(got[total // 3])


def test_microbatch_equivalence():
    """mb=2 grad accumulation == one big batch (same tokens)."""
    cfg = get_config("internlm2-1.8b-smoke")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    (m1, s1), (m2, s2) = _state(cfg), _state(cfg)
    ds = SyntheticLMDataset(cfg.vocab_size, 64, 8, seed=0)
    big = ds.batch(0)
    micro = {k: v.reshape(2, 4, *v.shape[1:]) for k, v in big.items()}
    s1, r1 = make_train_step(m1, opt)(s1, big)
    s2, r2 = make_train_step(m2, opt, microbatches=2)(s2, micro)
    assert float(r1["loss"]) == pytest.approx(float(r2["loss"]), rel=1e-5)
    for n, p in s1.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   s2.params[n].detach().numpy(), atol=1e-5)


def test_quantize_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(1000) * 3).astype(np.float32))
    q, s = quantize_int8(x)
    deq = dequantize_int8(q, s, x.shape)
    err = float((deq - x).abs().max())
    assert err <= float(x.abs().max()) / 127 + 1e-6


def test_error_feedback_converges_on_quadratic():
    target = torch.from_numpy(np.linspace(-2, 2, 512).astype(np.float32))
    w = {"w": torch.zeros(512)}
    init_state, compress = make_error_feedback_compressor(w)
    err = init_state()
    for _ in range(200):
        g = {"w": (w["w"] - target) * 0.5}
        g, err = compress(g, err)
        w = {"w": w["w"] - 0.5 * g["w"]}
    assert float((w["w"] - target).abs().max()) < 0.05


@pytest.mark.parametrize("n", [1000, 256, 3 * 256 + 7])
def test_compression_codes_and_scales_are_jax_bit_for_bit(n):
    """Ties included (``x`` on multiples of half a code step): ``round``
    goes half to even in both packages."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    x[:40] = np.round(x[:40] * 2) / 2           # exact halves
    jq, js = jax_quantize(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# ----------------------------------------------------------- test_data.py
def _eq_ref(mine, ref):
    assert set(mine) == set(ref)
    for k in ref:
        assert mine[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(mine[k], ref[k])


@pytest.mark.parametrize("kw", [dict(seed=3), dict(seed=2, num_shards=4,
                                                   shard=1),
                                dict(seed=0, branching=2)])
def test_batches_are_the_reference_bit_for_bit(kw):
    mine, ref = SyntheticLMDataset(512, 32, 8, **kw), JaxDataset(512, 32, 8,
                                                                 **kw)
    for step in (0, 5):
        _eq_ref(mine.batch(step), ref.batch(step))
    assert mine.entropy_floor == ref.entropy_floor
    a = make_batch_iterator(mine, 2, microbatches=2)
    b = jax_batch_iterator(ref, 2, microbatches=2)
    for _ in range(2):
        _eq_ref(next(a), next(b))


def test_labels_are_shifted_tokens():
    b = SyntheticLMDataset(512, 64, 4, seed=1).batch(0)
    assert b["tokens"].shape == b["labels"].shape == (4, 64)
    assert not np.array_equal(b["tokens"], b["labels"])
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_shards_reassemble_to_global_batch():
    full = SyntheticLMDataset(512, 32, 8, seed=2).batch(7)
    parts = [SyntheticLMDataset(512, 32, 8, seed=2, num_shards=4,
                                shard=s).batch(7) for s in range(4)]
    np.testing.assert_array_equal(
        np.concatenate([p["tokens"] for p in parts]), full["tokens"])


def test_iterator_restart_stable():
    ds = SyntheticLMDataset(512, 32, 4, seed=0)
    it1 = make_batch_iterator(ds, start_step=0)
    for _ in range(3):
        ref = next(it1)
    got = next(make_batch_iterator(ds, start_step=2))
    np.testing.assert_array_equal(ref["tokens"], got["tokens"])


def test_microbatch_layout_and_entropy_floor():
    ds = SyntheticLMDataset(512, 32, 8, seed=0)
    assert next(make_batch_iterator(ds, microbatches=2))["tokens"].shape \
        == (2, 4, 32)
    ds = SyntheticLMDataset(512, 32, 4, branching=4)
    assert 0.3 < ds.entropy_floor < np.log(4) + 1e-6


# -------------------------------------------------------- test_elastic.py
@pytest.mark.parametrize("plan, healthy, batch", [
    ((16, 16, 1), 240, 256), ((16, 16, 1), 128, 256), ((16, 16, 2), 384, 256),
    ((8, 4, 1), 30, 96), ((4, 8, 1), 8, 7)])
def test_replan_mesh_is_the_reference(plan, healthy, batch):
    got = replan_mesh(MeshPlan(*plan), healthy, batch)
    want = jax_replan_mesh(JaxMeshPlan(*plan), healthy, batch)
    assert (got.data, got.model, got.pod, got.devices) == (
        want.data, want.model, want.pod, want.devices)
    assert got.model == plan[1] and batch % got.data == 0
    assert got.devices <= healthy


def test_straggler_detection_and_reassignment():
    pols = StragglerPolicy(threshold=2.0), JaxStragglerPolicy(threshold=2.0)
    hosts = [f"h{i}" for i in range(4)]
    for _ in range(10):
        for h in hosts:
            for pol in pols:
                pol.observe(h, 1.0 if h != "h2" else 5.0)
    assert pols[0].stragglers() == pols[1].stragglers() == ["h2"]
    assign = pols[0].reassign_shards(8, hosts)
    assert assign == pols[1].reassign_shards(8, hosts)
    assert "h2" not in assign.values() and sorted(assign) == list(range(8))
    pol = StragglerPolicy()
    for h in ("a", "b"):
        pol.observe(h, 1.0)
    assert pol.stragglers() == []
    assert set(pol.reassign_shards(4, ["a", "b"]).values()) == {"a", "b"}


# ------------------------------------------------ the CLI and the example
def test_train_cli_runs_and_checkpoints(capsys):
    report = {}
    loss = train_cli.main(["--device", "cpu", "--arch", "minicpm-2b-smoke",
                           "--steps", "4", "--seq", "32", "--batch", "4",
                           "--microbatches", "2", "--ckpt-every", "2"],
                          report=report)
    out = capsys.readouterr().out
    assert "ckpt[log] step 4" in out and "tok/s (CPU)" in out
    assert len(report["losses"]) == 4 and loss == report["losses"][-1]
    assert all(np.isfinite(report["losses"]))
    # minicpm trains on the WSD schedule (cfg.lr_schedule)
    assert report["opt_cfg"].schedule == "wsd"


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_crash_and_bit_exact_resume(capsys, monkeypatch):
    """The example's loop at a small width (its config's family and
    schedule, d_model 64): saves at 10 and 20, a crash at 23, the restore
    bit for bit the step-20 state (every leaf, ``count`` and ``step``
    too), and the replayed steps 21–23 giving the first run's losses."""
    mod = _example()
    full = mod.build_100m
    monkeypatch.setattr(mod, "build_100m", lambda n: dataclasses.replace(
        full(n), d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=512, head_dim=16))
    rc = mod.main(["--device", "cpu", "--steps", "24", "--crash-at", "23",
                   "--batch", "2", "--seq", "16", "--layers", "2",
                   "--deterministic", "--verify"])
    torch.use_deterministic_algorithms(False)
    out = capsys.readouterr().out
    res = json.loads(out.strip().splitlines()[-1])["resume"]
    assert rc == 0
    assert [s["step"] for s in res["saves"]] == [10, 20]
    assert res["restore"]["step"] == 20 and res["restore"]["bit_equal"]
    # params, mu, nu, master: 21 tensors each; count and step
    assert res["restore"]["leaves"] == 4 * 21 + 2
    assert res["replayed_steps"] == [21, 22, 23] and res["replay_bit_equal"]
