"""End-to-end training entry point of the port (a CLI).

Integrates the synthetic data pipeline, AdamW (+WSD for minicpm) with fp32
masters, microbatching, per-layer activation checkpointing, and
checkpoint/restart through the paper's cache designs. The JAX package's
``launch/train.py`` with the same flags, plus ``--device`` (the GPU unless
``--device cpu``) and ``--dtype`` (the compute dtype of the weights;
``bfloat16`` keeps fp32 masters in the optimizer). A sequence longer than
the model's ``chunk_size`` (512) attends through the hand-written
flash-attention kernel on the card, under its autograd Function.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch internlm2-1.8b-smoke --steps 50 --ckpt-design log \\
        --ckpt-every 10
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import REGISTRY, get_config
from repro_torch.data import SyntheticLMDataset, make_batch_iterator
from repro_torch.models import LM
from repro_torch.training import (AdamWConfig, init_train_state,
                                  make_train_step)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None, report: dict | None = None):
    """Run the CLI; returns the last step's loss. A ``report`` dict, when
    given, is filled with each step's loss and wall seconds (to a device
    sync), the tokens a step, the peak device memory, and the model, its
    train state and the optimizer config, for a caller that inspects the
    run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="internlm2-1.8b-smoke",
                    choices=sorted(REGISTRY))
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-design", choices=("log", "paged"), default="log")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    model = LM(cfg, dtype=DTYPES[args.dtype], device=args.device,
               remat=True)
    dev = model.device
    opt_cfg = AdamWConfig(lr=args.lr, schedule=cfg.lr_schedule,
                          warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    state = init_train_state(model,
                             torch.Generator(dev).manual_seed(args.seed))
    step_fn = make_train_step(model, opt_cfg,
                              microbatches=args.microbatches)

    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch,
                            seed=args.seed)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"loss_floor≈{ds.entropy_floor:.3f}")

    mgr = None
    start_step = 0
    if args.ckpt_every:
        mgr = CheckpointManager(args.ckpt_design)
        if args.resume:
            start_step, state = mgr.restore(state)
            start_step = int(start_step)
            print(f"resumed at step {start_step}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    it = make_batch_iterator(ds, start_step, args.microbatches)
    losses, step_s = [], []
    t0 = time.time()
    for step in range(start_step, args.steps):
        ts = time.perf_counter()
        state, metrics = step_fn(state, next(it))
        if report is not None:
            sync()
            step_s.append(time.perf_counter() - ts)
            losses.append(float(metrics["loss"]))
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            t = mgr.save(step + 1, state)
            print(f"  ckpt[{args.ckpt_design}] step {step+1} "
                  f"sim_save={t*1e3:.2f}ms")
    sync()
    dt = time.time() - t0
    tokens = (args.steps - start_step) * args.batch * args.seq
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU")
    print(f"done: {dt:.1f}s wall, {tokens/dt:.0f} tok/s ({where})")
    if report is not None:
        report.update(
            losses=losses, step_s=step_s, wall_s=dt,
            tokens_per_step=args.batch * args.seq, model=model,
            state=state, opt_cfg=opt_cfg,
            peak_bytes=(torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else None))
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
