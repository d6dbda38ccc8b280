"""Serving example on the PyTorch port: continuous-batching generation with
the tiered KV cache, comparing the paper's designs at the serving
call-site — including preemption under HBM pressure and the mirror-free
pooled decode path (decode straight over the device page pool through the
hand-written paged-attention kernels, zero device→host mirror traffic).
The cache-descriptor support matrix shows which serving path each
(engine, model family) pair runs, and the family sweep drives int8 and
SSM through the same pooled mirror-free path. The twin of
``examples/serve_kv_offload.py``, with its asserts; random fp32 weights
from a seed (the two packages draw different numbers from one seed, so
the tokens are the port's own, held to its own sequential reference).

    PYTHONPATH=src python examples/serve_kv_offload_torch.py      # the GPU
    PYTHONPATH=src python examples/serve_kv_offload_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.engines import EngineSpec, list_kv_engines
from repro_torch.core.engines.desc import MATRIX_FAMILIES, support_matrix
from repro_torch.models import LM
from repro_torch.serving import Request, ServeConfig, ServingEngine

DEVICE = "cuda"


def build_model(cfg, kv_cache_dtype="native", seed=0):
    """The smoke model in fp32 on ``DEVICE``, random weights from
    ``seed``."""
    return LM(cfg, device=DEVICE, remat=False,
              kv_cache_dtype=kv_cache_dtype).init(
        torch.Generator(DEVICE).manual_seed(seed))


def serving_engine(model, cfg):
    return ServingEngine(model, cfg, device=DEVICE)


def print_matrix():
    rows = support_matrix()
    fams = [f for f, _, _ in MATRIX_FAMILIES]
    modes = {(e, f): m for e, f, m in rows}
    engines = sorted({e for e, _, _ in rows})
    width = max(max(len(f) for f in fams),
                max(len(m) for m in modes.values())) + 2
    print("KV engine x config family (from the cache descriptors):")
    print("  " + " " * 10 + "".join(f"{f:>{width}}" for f in fams))
    for eng in engines:
        print(f"  {eng:10s}" + "".join(f"{modes[(eng, f)]:>{width}}"
                                       for f in fams))
    print()


def family_sweep():
    """int8 and SSM through the SAME pooled mirror-free path dense runs:
    the descriptor decides the layout (int8 pages + bf16 scale planes at
    half the HBM bytes/token; SSM state rows instead of pages), and greedy
    tokens still match the sequential mirrored reference exactly."""
    print("descriptor-driven families on the pooled path")
    cfg = get_config("internlm2-1.8b-smoke")
    scfg = get_config("mamba2-1.3b-smoke")
    runs = (
        ("int8", build_model(cfg, kv_cache_dtype="int8"), cfg),
        ("ssm", build_model(scfg), scfg),
    )
    for fam, model, mcfg in runs:
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, mcfg.vocab_size, 12, dtype=np.int32)
                   for _ in range(2)]

        def reqs():
            return [Request(rid=i, prompt=p.copy(), max_new=8)
                    for i, p in enumerate(prompts)]

        def engine():
            return serving_engine(model, ServeConfig(
                max_len=32, page_tokens=8,
                engine_spec=EngineSpec(engine="paged", kv_hot_window=16,
                                       kv_hbm_bytes=64 << 20),
                max_batch_seqs=2))
        ref = reqs()
        engine().generate_sequential(ref)
        eng, rs = engine(), reqs()
        assert eng.pooled and eng.fused
        eng.generate(rs)
        s = eng.stats()
        assert [r.generated for r in rs] == [r.generated for r in ref], fam
        assert s["mirror_d2h_bytes"] == 0
        desc = model.cache_descriptor(8)
        names = [pl.name for pl in desc.paged_planes + desc.seq_planes]
        print(f"  family={fam:5s} planes={','.join(names):24s} "
              f"mirror_d2h_bytes=0 tokens=reference "
              f"(token_bytes={desc.token_group_bytes or desc.seq_state_bytes})")
    print()


def crash_and_recover():
    """Fault tolerance: crash the scheduler mid-run with chaos
    transfer faults underneath, then recover a FRESH engine from the shared
    NVMM token journal — the spliced stream is token-identical to the
    uninterrupted reference."""
    from repro_torch.serving.faults import CrashFault, FaultPlan
    from repro_torch.serving.journal import ServingJournal
    print("crash-and-recover through the NVMM token journal")
    cfg = get_config("internlm2-1.8b-smoke")
    model = build_model(cfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 12, dtype=np.int32)
               for _ in range(3)]

    def reqs():
        return [Request(rid=i, prompt=p.copy(), max_new=12)
                for i, p in enumerate(prompts)]

    def engine(journal, plan):
        return serving_engine(model, ServeConfig(
            max_len=32, page_tokens=8,
            engine_spec=EngineSpec(engine="paged", kv_hot_window=16,
                                   drain_shards=2, kv_hbm_bytes=64 << 20,
                                   async_tiering=True),
            max_batch_seqs=2, journal=journal, fault_plan=plan))

    ref = reqs()
    engine(None, None).generate_sequential(ref)
    reference = [r.generated for r in ref]

    journal = ServingJournal()
    plan = FaultPlan(seed=7, transfer_fail_rate=0.2,
                     transfer_delay_rate=0.2, crash_at_tick=6)
    crashed, rs = engine(journal, plan), reqs()
    try:
        crashed.generate(rs)
        raise AssertionError("the injected crash must fire")
    except CrashFault as e:
        state, last_tick = journal.replay()
        durable = sum(len(t) for t in state.values())
        print(f"  {e} — journal holds {durable} committed tokens "
              f"across {len(state)} rows through tick {last_tick}")
    recovered = engine(journal, None)
    recovered.recover(rs)
    assert [r.generated for r in rs] == reference, \
        "recovery must splice to the exact reference stream"
    print(f"  recovered engine finished all rows; tokens identical to the "
          f"uninterrupted reference "
          f"(journal_appends={recovered.stats()['journal_appends']})")
    print()


def main(argv=None):
    global DEVICE
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the kernels' plain "
                         "versions run")
    DEVICE = ap.parse_args(argv).device
    print_matrix()
    family_sweep()
    crash_and_recover()
    cfg = get_config("internlm2-1.8b-smoke")
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 24, dtype=np.int32)
               for _ in range(3)]

    def run(design, hbm_bytes, sequential=False, paged_decode=None,
            chunk=None):
        engine = serving_engine(model, ServeConfig(
            max_len=64, page_tokens=8,
            engine_spec=EngineSpec(engine=design, kv_hot_window=16,
                                   drain_shards=2, kv_hbm_bytes=hbm_bytes),
            max_batch_seqs=4, paged_decode=paged_decode,
            prefill_chunk_tokens=chunk))
        reqs = [Request(rid=i, prompt=p.copy(), max_new=16)
                for i, p in enumerate(prompts)]
        (engine.generate_sequential if sequential
         else engine.generate)(reqs)
        return [r.generated for r in reqs], engine

    # the reference every path below must reproduce token-for-token: the
    # one-request-at-a-time loop over the dense mirror
    reference, _ = run("log", 64 << 20, sequential=True,
                       paged_decode=False)
    designs = list_kv_engines()          # paged, log, kvhybrid, plugins...

    # ---- mirror-free pooled decode: every registered engine, unconstrained
    # budget. Pool-capable engines decode over their device page pool with
    # ZERO device→host mirror bytes; the rest fall back to the mirror path
    # transparently — and everyone still generates the reference tokens.
    print("pooled decode (auto: pool-capable engines go mirror-free)")
    for design in designs:
        out, eng = run(design, 64 << 20, chunk=12)
        s = eng.stats()
        mode = "pooled" if eng.pooled else "mirror"
        print(f"  design={design:8s} path={mode:6s} "
              f"mirror_d2h_bytes={s['mirror_d2h_bytes']:8d} "
              f"prefill_chunks={s['sched_prefill_chunks']}")
        assert out == reference, (design, "pooled decode must match the "
                                  "sequential mirrored reference")
        if eng.pooled:
            assert s["mirror_d2h_bytes"] == 0, \
                "the pooled path must never mirror a token device→host"
        assert s["sched_prefill_chunks"] >= 1, \
            "24-token prompts over a 12-token chunk budget must split"

    # ---- preemption under HBM pressure: a budget with room for two
    # requests to co-run, not three, so the scheduler must preempt/restore
    # mid-decode, and tokens must not change
    token_bytes = (cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 2)
    print("preemption under a binding HBM budget")
    outputs = {}
    for design in designs:
        # pooled paged accounts whole fp32 pool pages (2x the fp16
        # token_bytes) and refuses admissions it cannot place, so its
        # squeeze point differs: 9 pool pages — the smallest pool the
        # liveness floor (max_len/page_tokens + 1) accepts — admit two
        # prompts (3 pages each) but not their decoded growth (5 each)
        budget = (9 * 8 * token_bytes * 2 if design == "paged"
                  else 40 * token_bytes)
        outputs[design], eng = run(design, budget)
        assert (design != "paged") or eng.pooled, \
            "paged must stay on the pooled path in the pressure run"
        s = eng.stats()
        print(f"  design={design:8s} sim_tier_time="
              f"{s['sim_time_s']*1e6:9.1f}us preempts={s['preempts']} "
              f"restores={s['restores']} "
              f"peak_batch={s['sched_peak_running']}")
        assert s["preempts"] >= 1, "budget should have forced a preemption"
    assert all(outputs[d] == reference for d in designs), \
        "batched + preempted decode must match the sequential reference"
    print(f"\nall {len(designs)} registered KV designs, decoding as ONE "
          "continuously-batched pool under a budget that forces "
          "preempt/restore cycles, generated exactly the sequential "
          "reference tokens — and the paged design did it MIRROR-FREE: "
          "decode ran the paged_attention kernel straight over its "
          "device-resident page pool (block-table indirection), spilling "
          "LRU pool pages at page granularity under pressure, with zero "
          "device→host mirror traffic. The designs differ only in tier "
          "traffic (paging pays page DMA + page-granular spills; logging "
          "pays 1x sequential writes + patch reads; kvhybrid routes each "
          "append to whichever side wins it) — the paper's trade-off "
          "transplanted to the serving tier.")


if __name__ == "__main__":
    main()
