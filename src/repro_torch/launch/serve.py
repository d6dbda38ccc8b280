"""Serve requests through the port's tiered KV engines.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --dtype bfloat16 --requests 8 --prompt-len 256 --max-new 32 \
        --prefill-chunk-tokens 128

Requests share one running batch (admitted/preempted/restored by the
scheduler); every tick is one ragged forward. ``--design`` (alias
``--engine``) picks the KV engine from the registry: ``paged`` (the
default) serves pooled, its attention the hand-written paged-attention
kernel over the device page pool; ``log`` and ``kvhybrid`` serve through
the dense mirror (plain torch attention over per-request cache rows on
the card, new tokens mirrored into the host log), ``--drain-shards``
setting their drainer parallelism. ``--paged-decode`` requires the pool,
``--mirror-decode`` forces the mirror (``paged`` then runs host mode);
the default picks the pool when the engine has one and the budget fits:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --design kvhybrid --drain-shards 4

``--hbm-budget-bytes`` small enough to bind makes preemption visible in the
printed stats; ``--sequential`` runs the one-at-a-time dense reference
instead (same tokens). ``--arch deepseek-v2-236b-noexperts`` serves the
MLA latent pool; ``--arch mamba2-1.3b`` serves Mamba-2 from per-sequence
state rows on ``paged`` (fused over the mirror on ``log``/``kvhybrid``),
and ``--arch zamba2-1.2b`` serves the hybrid on the unfused mirror on
every design (no cache descriptor). Weights are random, drawn from
``--seed``. Runs on the GPU unless ``--device cpu``.

``--prefix-cache-tokens`` turns on the prefix cache (``--shared-prefix-
tokens`` gives every prompt the same head to hit it); ``--speculate-k``
turns on self-drafted speculative decode; ``--fault-rate``/``--fault-seed``
inject transfer faults, ``--crash-at-tick`` a crash, and ``--journal``
keeps the token journal a crashed run recovers from:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --shared-prefix-tokens 16 --prefix-cache-tokens 4096 \
        --speculate-k 4 --journal --crash-at-tick 3
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import REGISTRY, get_config
from repro_torch.core.engines import EngineSpec, list_kv_engines
from repro_torch.models import LM
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.serving.faults import CrashFault, FaultPlan
from repro_torch.serving.journal import ServingJournal


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="internlm2-1.8b-smoke",
                    choices=sorted(REGISTRY))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--design", "--engine", dest="design",
                    choices=list_kv_engines(), default="paged",
                    help="KV engine from the registry")
    ap.add_argument("--drain-shards", type=int, default=1,
                    help="per-shard drainer parallelism (log/kvhybrid)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch-seqs", type=int, default=8,
                    help="continuous-batching width cap")
    ap.add_argument("--max-batch-tokens", type=int, default=None,
                    help="running-batch token cap (None = unlimited)")
    ap.add_argument("--hbm-budget-bytes", type=int, default=64 << 20,
                    help="KV pool budget; small values force "
                         "preempt/restore cycles")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--paged-decode", dest="paged_decode",
                      action="store_true", default=None,
                      help="require mirror-free decode over the device page "
                           "pool (needs a pool-capable engine)")
    mode.add_argument("--mirror-decode", dest="paged_decode",
                      action="store_false",
                      help="force the dense-mirror decode path")
    ap.add_argument("--page-tokens", type=int, default=16,
                    help="tokens per KV page (pool geometry)")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=None,
                    help="split prompts longer than this across ticks "
                         "(default: max-batch-tokens)")
    ap.add_argument("--no-fuse", dest="fuse_ticks", action="store_false",
                    help="unfused baseline: prefill chunks run token by "
                         "token through the decode kernel")
    ap.add_argument("--sequential", action="store_true",
                    help="run the batch=1 dense reference loop instead of "
                         "the continuous-batching scheduler")
    ap.add_argument("--prefix-cache-tokens", type=int, default=0,
                    help="cross-request prefix cache capacity in tokens "
                         "(0 = off): cache-hit admissions splice shared "
                         "pool pages instead of prefilling")
    ap.add_argument("--shared-prefix-tokens", type=int, default=0,
                    help="prepend this many identical tokens to every "
                         "prompt (exercises the prefix cache)")
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="speculative decode: up to k self-drafted tokens "
                         "per decode row per fused tick, verified in the "
                         "same launch (0 = off; tokens are identical "
                         "either way)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for deterministic fault injection (the same "
                         "seed replays the same faults)")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="per-attempt transfer fail AND delay probability "
                         "(>0 turns on the injector; retries/degradation "
                         "show up in the printed stats)")
    ap.add_argument("--crash-at-tick", type=int, default=None,
                    help="inject a CrashFault at this scheduler tick; with "
                         "--journal the run then recovers from the journal "
                         "and prints both halves")
    ap.add_argument("--journal", action="store_true",
                    help="append committed tokens to a crash-consistent "
                         "NVMM journal every tick (required for recovery "
                         "after --crash-at-tick)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    model = LM(cfg, dtype=getattr(torch, args.dtype), device=args.device)
    model.init(torch.Generator(model.device).manual_seed(args.seed))
    prompt_len = args.prompt_len + args.shared_prefix_tokens
    max_len = prompt_len + args.max_new + 1
    max_len += -max_len % args.page_tokens     # pool wants page alignment

    journal = ServingJournal() if args.journal else None
    fault_plan = None
    if args.fault_rate > 0.0 or args.crash_at_tick is not None:
        fault_plan = FaultPlan(seed=args.fault_seed,
                               transfer_fail_rate=args.fault_rate,
                               transfer_delay_rate=args.fault_rate,
                               crash_at_tick=args.crash_at_tick)

    def mk_engine(plan):
        return ServingEngine(model, ServeConfig(
            max_len=max_len, page_tokens=args.page_tokens,
            engine_spec=EngineSpec(
                engine=args.design, drain_shards=args.drain_shards,
                kv_hbm_bytes=args.hbm_budget_bytes,
                prefix_cache_tokens=args.prefix_cache_tokens),
            max_batch_seqs=args.max_batch_seqs,
            paged_decode=args.paged_decode,
            max_batch_tokens=args.max_batch_tokens,
            prefill_chunk_tokens=args.prefill_chunk_tokens,
            fuse_ticks=args.fuse_ticks, speculate_k=args.speculate_k,
            journal=journal, fault_plan=plan), device=args.device)

    engine = mk_engine(fault_plan)
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, cfg.vocab_size, args.shared_prefix_tokens,
                          dtype=np.int32)
    reqs = [Request(rid=i,
                    prompt=np.concatenate([
                        shared,
                        rng.integers(0, cfg.vocab_size, args.prompt_len,
                                     dtype=np.int32)]),
                    max_new=args.max_new)
            for i in range(args.requests)]
    if args.sequential:
        engine.generate_sequential(reqs)
    else:
        try:
            engine.generate(reqs)
        except CrashFault as e:
            print(f"CRASH: {e} (journal stats: "
                  f"{journal.stats if journal else None})")
            if journal is None:
                raise SystemExit(
                    "crashed without --journal: nothing durable to recover")
            # a fresh engine sharing the SAME journal resumes exactly where
            # the last durable tick stopped
            engine = mk_engine(None)
            engine.recover(reqs)
            print("RECOVERED: journal replayed, unfinished rows resumed")
    for r in reqs:
        print(f"req {r.rid}: generated {len(r.generated)} tokens "
              f"{r.generated[:8]}...")
    mode = ("sequential" if args.sequential else
            ("batched+pooled" if engine.pooled else "batched+mirror")
            + ("+fused" if engine.fused else ""))
    print(f"tiered-kv[{args.design}] ({mode}) stats: {engine.stats()}")


if __name__ == "__main__":
    main()
