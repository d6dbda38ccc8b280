"""Serve requests through the port's pooled, fused paged-KV engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --dtype bfloat16 --requests 8 --prompt-len 256 --max-new 32 \
        --prefill-chunk-tokens 128

Requests share one running batch (admitted/preempted/restored by the
scheduler); every tick is one ragged forward whose attention runs the
hand-written paged-attention kernel over the device page pool.
``--hbm-budget-bytes`` small enough to bind makes preemption visible in the
printed stats; ``--sequential`` runs the one-at-a-time dense reference
instead (same tokens). ``--arch deepseek-v2-236b-noexperts`` serves the
MLA latent pool. Weights are random, drawn from ``--seed``. Runs on the GPU
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import REGISTRY, get_config
from repro_torch.core.engines import EngineSpec
from repro_torch.models import LM
from repro_torch.serving import Request, ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="internlm2-1.8b-smoke",
                    choices=sorted(REGISTRY))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    model = LM(cfg, dtype=getattr(torch, args.dtype), device=args.device)
    model.init(torch.Generator(model.device).manual_seed(args.seed))
    max_len = args.prompt_len + args.max_new + 1
    max_len += -max_len % args.page_tokens     # pool wants page alignment
    engine = ServingEngine(model, ServeConfig(
        max_len=max_len, page_tokens=args.page_tokens,
        engine_spec=EngineSpec(engine="paged",
                               kv_hbm_bytes=args.hbm_budget_bytes),
        max_batch_seqs=args.max_batch_seqs,
        max_batch_tokens=args.max_batch_tokens,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        fuse_ticks=args.fuse_ticks), device=args.device)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               args.prompt_len,
                                               dtype=np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    if args.sequential:
        engine.generate_sequential(reqs)
    else:
        engine.generate(reqs)
    for r in reqs:
        print(f"req {r.rid}: generated {len(r.generated)} tokens "
              f"{r.generated[:8]}...")
    mode = ("sequential" if args.sequential else
            "batched+pooled" + ("+fused" if engine.fused else ""))
    print(f"tiered-kv[paged] ({mode}) stats: {engine.stats()}")


if __name__ == "__main__":
    main()
