"""The DeepSeek-V2 cell at smoke size on the CPU: its configuration read
into the port, the program against the fp32 reference through the pooled
fused tick, the loop and its faults, and the readers of its MoE metrics.

* prefill, then decode through the MLA pool, with the pooled fused tick
  (``Scheduler`` over ``ServingEngine``): every logit row the program
  computed lies within ``LOGIT_ATOL`` of the reference's full forward
  (:mod:`perfbench.reference.moe_decoder`) over the same tokens, fp32 on
  both sides; the same program in bf16 lies past it;
* the cell's loop (``closed_moe``), untraced and traced, is ``correct``,
  and each fault planted underneath it (tokens altered, the pool left
  unwritten, the held experts' output dropped) is not, nor one row of 64
  served wrong;
* the readers of ``expert_roofline``, ``moe_ms`` and
  ``expert_rows_per_tick`` on a synthetic trace worked out by hand, and
  no number from a program without the MoE ranges and counters.
"""
import time

import numpy as np
import pytest
import torch

from perfbench import bench, moe_counts, moe_phases
from perfbench import moe_weights as mw
from perfbench.bench import metric_reader
from perfbench.loops.closed_moe import program_config
from perfbench.reference import moe_decoder
from perfbench.tests.test_perfbench_loops import (_alter_tokens,
                                                  _pool_unchanged)
from perfbench.tests.test_perfbench_phases import CUDA, Ev, FakeTrace
from perfbench.tests.tiny import ROOT, small_mix

CELL = "deepseek-v2-chat-closed64"
CPU = torch.device("cpu")
# fp32 on both sides: the program's rows differ from the reference's full
# forward only by its other order of sums (the absorbed MLA, the paged
# pool, the grouped experts), 3.4e-6 here; bf16 compute lies 0.58 off
# (its rounding moves routing decisions), so it fails by far
LOGIT_ATOL = 1e-4


def tiny_config(dtype="bfloat16") -> dict:
    """The cell's configuration at smoke widths: 3 layers (one dense),
    4 held experts (4-7) of the router's 16 in 4 groups, top-2 groups,
    top-3, a q LoRA, YaRN as published."""
    c = dict(bench.resolve(CELL, ROOT).config)
    c.update(name="dsv2-tiny", num_hidden_layers=3, hidden_size=128,
             num_attention_heads=4, num_key_value_heads=4,
             intermediate_size=256, vocab_size=512, q_lora_rank=48,
             kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
             v_head_dim=32, moe_intermediate_size=64, n_routed_experts=4,
             n_routed_experts_published=16, held_first_expert=4, n_group=4,
             topk_group=2, num_experts_per_tok=3, torch_dtype=dtype)
    return c


def cell() -> bench.Cell:
    full = bench.resolve(CELL, ROOT)
    return bench.Cell(CELL, full.workload, tiny_config(),
                      small_mix(full.workload["traffic"]), dict(full.limits),
                      full.end_to_end, full.per_layer, ROOT)


def run(trace=False):
    return bench.run_cell(cell(), 2 ** 31 + 77, 3.0, trace, CPU,
                          time.perf_counter())


# ------------------------------------------------ the program and the reference
def served_logit_rows(dtype):
    """Serve four requests through the pooled fused tick; return the
    model's rows, the arch and, per request, its tokens and each logit
    row the program computed at a position of them."""
    from repro_torch.core.engines.base import EngineSpec
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import Request, ServeConfig, ServingEngine
    from repro_torch.serving.scheduler import Scheduler
    c = tiny_config(dtype)
    a = mw.MoEArch(c)
    model = LM(program_config(c), dtype=a.dtype, device=CPU)
    mw.fill_module(model, a, 11)
    eng = ServingEngine(model, ServeConfig(
        max_len=64, page_tokens=4, max_batch_seqs=4, prefill_chunk_tokens=6,
        fuse_ticks=True, paged_decode=True,
        engine_spec=EngineSpec(engine="paged", kv_hbm_bytes=64 << 20)),
        device=CPU)
    assert eng.pooled and eng.fused
    rows: dict = {}                          # rid → {position: logits}
    step, prefill = eng.step_batch, eng.prefill_one

    def step_batch(rids, caches, tok_rows, *args, **kw):
        starts = [eng.tiered.seq_len.get(r, 0) for r in rids]
        out = step(rids, caches, tok_rows, *args, **kw)
        for rid, s, lg in zip(rids, starts, out[0]):
            for i in range(lg.shape[1]):
                rows.setdefault(rid, {})[s + i] = lg[0, i].float()
        return out

    def prefill_one(req, n=None, tokens=None):
        lg, cache = prefill(req, n, tokens)
        rows.setdefault(req.rid, {})[(n or len(req.prompt)) - 1] = \
            lg[0, -1].float()
        return lg, cache
    eng.step_batch, eng.prefill_one = step_batch, prefill_one
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, a.V, n).astype(np.int32),
                    max_new=7) for i, n in enumerate((9, 14, 5, 11))]
    Scheduler(eng, reqs).run()
    return a, reqs, rows


@pytest.fixture(scope="module")
def fp32_rows():
    torch.set_num_threads(1)
    return served_logit_rows("float32")


def _widest(a, reqs, rows):
    widest = 0.0
    seqs = [torch.as_tensor(np.concatenate([r.prompt, r.generated]))
            for r in reqs]
    xs = moe_decoder.hidden_states(a, 11, seqs, CPU)
    ln = mw.draw(a, 11, "final_ln", CPU, torch.float32)
    head = mw.draw(a, 11, "head", CPU, torch.float32)[:a.V]
    for r, x in zip(reqs, xs):
        want = moe_decoder.rmsnorm(x, ln, a.eps) @ head.T
        got = rows[r.rid]
        # every position that produced a served token, and chunk rows
        served = set(range(len(r.prompt) - 1,
                           len(r.prompt) + len(r.generated) - 1))
        assert served <= set(got) <= set(range(len(x)))
        for pos, lg in got.items():
            widest = max(widest, float((lg[:a.V] - want[pos]).abs().max()))
    return widest


def test_prefill_and_decode_match_the_reference(fp32_rows):
    moe_decoder.exact_fp32()
    a, reqs, rows = fp32_rows
    assert all(len(r.generated) == 7 for r in reqs)
    assert _widest(a, reqs, rows) < LOGIT_ATOL


def test_bf16_compute_fails_the_tolerance():
    """The same weights (drawn in bf16, the reference widening them),
    computed in bf16: past the tolerance."""
    moe_decoder.exact_fp32()
    a, reqs, rows = served_logit_rows("bfloat16")
    assert _widest(a, reqs, rows) > LOGIT_ATOL


# ------------------------------------------------------------------- the loop
@pytest.mark.parametrize("trace", [False, True])
def test_loop_runs_and_is_correct(trace):
    res, out = run(trace)
    c = cell()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    if trace:
        got = set(res["metrics"])
        assert {"expert_rows_per_tick.dsv2", "slot_use.dsv2",
                "mfu.serve", "tick_ms.serve", "idle_share.serve",
                "syncs_per_tick.dsv2", "idle_forward.dsv2",
                "rows_per_tick.serve", "pool_pressure_peak.serve",
                "logit_mib_per_tick.dsv2"} <= got
        assert res["metrics"]["expert_rows_per_tick.dsv2"]["value"] > 0
        # no card: no device time, so no roofline and no MoE device time
        assert not got & {"mla_roofline.dsv2", "expert_roofline.dsv2",
                          "moe_ms.dsv2"}
    else:
        assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
    assert {"imports", "libraries", "weights", "pool"} <= set(
        out.setup_parts)


def _experts_dropped(monkeypatch):
    from repro_torch.models import moe
    held = moe.held_experts

    def dropped(*a, **k):
        y, rows, run = held(*a, **k)
        return torch.zeros_like(y), rows, run
    monkeypatch.setattr(moe, "held_experts", dropped)


@pytest.mark.parametrize("fault", [_alter_tokens, _pool_unchanged,
                                   _experts_dropped],
                         ids=["alter_tokens", "pool_unchanged",
                              "experts_dropped"])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res, _ = run()
    assert not res["correct"], res["checks"]


def test_a_fault_in_one_row_fails_the_check():
    """One row of 64 served wrong all through, the others sound: the
    mean gap stays under its limit, the 99th percentile does not (gaps at
    the cell's sound and fp8 control readings, PERF.md)."""
    from perfbench.loops.closed_moe import gap_readings
    lim = bench.resolve(CELL, ROOT).limits
    rows = [torch.full((7,), 0.012, dtype=torch.float64)] * 63 \
        + [torch.full((7,), 0.6, dtype=torch.float64)]
    got = gap_readings(rows)
    assert got["logit_gap_mean"] < lim["logit_gap_mean"]
    assert got["logit_gap_p99"] > lim["logit_gap_p99"]
    sound = gap_readings([torch.full((7,), 0.012, dtype=torch.float64)] * 64)
    assert all(sound[n] <= v for n, v in lim.items())


# ---------------------------------------------------------------- the readers
def moe_trace():
    """Two ticks of [0, 1000) and [1000, 2000), each with a route, an
    experts and a shared range; each range launches one kernel that runs
    300 ns later (in another range's time), and a kernel outside every
    range counts for nothing."""
    ev = []
    for base in (0, 1000):
        ev.append(Ev("repro_torch.tick", base, 1000))
        for k, (name, t, dur) in enumerate([("route", 100, 10),
                                            ("experts", 200, 100),
                                            ("shared", 400, 40)]):
            corr = base + k + 1
            ev += [Ev("repro_torch.moe." + name, base + t, 50),
                   Ev("cudaLaunchKernel", base + t + 5, 5, corr),
                   Ev("k", base + t + 300, dur, corr, CUDA)]
        ev += [Ev("cudaLaunchKernel", base + 700, 5, base + 9),
               Ev("k", base + 720, 30, base + 9, CUDA)]
    return FakeTrace(0, 2000, ev)


def test_moe_readers_on_a_worked_trace():
    from repro_torch import telemetry
    a = mw.MoEArch(bench.resolve(CELL, ROOT).config)
    telemetry.clear()
    try:
        before = (0,) * 8
        for start, rows, run in ((0, 300, 20), (1000, 500, 19)):
            telemetry.record_tick(start + 1, start + 999, before,
                                  (0, 0, 0, 0, 0, torch.tensor(rows),
                                   torch.tensor(rows // 2),
                                   torch.tensor(run)))
        ctx = {"trace": moe_trace(), "arch": a}
        assert moe_phases.device_s_in(ctx, moe_phases.EXPERTS) == \
            pytest.approx(200e-9)
        assert metric_reader("moe_ms.dsv2")(ctx) == \
            pytest.approx(1e3 * 300e-9 / 2)
        assert metric_reader("expert_rows_per_tick.dsv2")(ctx) == 400
        bound = (moe_counts.expert_bound_s(300, 20, a)
                 + moe_counts.expert_bound_s(500, 19, a))
        assert metric_reader("expert_roofline.dsv2")(ctx) == \
            pytest.approx(100 * bound / 200e-9)
    finally:
        telemetry.clear()


@pytest.mark.parametrize("name", ["expert_roofline.dsv2", "moe_ms.dsv2",
                                  "expert_rows_per_tick.dsv2"])
def test_no_moe_ranges_no_number(name):
    """A program that keeps no MoE counter in its tick records (the
    parent's) and opens no MoE range: each reader finds nothing."""
    from repro_torch import telemetry
    telemetry.clear()
    ctx = {"trace": FakeTrace(0, 1000, [Ev("repro_torch.tick", 0, 500)]),
           "arch": None}
    assert metric_reader(name)(ctx) is None
    assert metric_reader(name)({"trace": None, "arch": None}) is None


def test_mla_work_counts_live_pages_and_pairs():
    a = mw.MoEArch(bench.resolve(CELL, ROOT).config)
    nbytes, flops = moe_counts.mla_work([(40, 1), (20, 4), (7, 0)], 16, a)
    assert nbytes == (3 + 2) * 16 * 576 * 2 + 5 * 128 * (2 * 512 + 64) * 4
    assert flops == 128 * (2 * 576 + 2 * 512) * (40 + (4 * 16 + 10))
