"""End-to-end training on the PyTorch port: train a ~100M-parameter LM on
synthetic data with log-structured checkpointing (NVLog), a mid-run
simulated crash, and bit-exact resume. The port's twin of
``examples/train_lm.py``: the same config, schedule, checkpoint cadence
and crash, on the GPU unless ``--device cpu``.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200

``--layers`` cuts the depth of the 10-layer config for a quick run.
``--deterministic`` turns on PyTorch's deterministic algorithms (and sets
``CUBLAS_WORKSPACE_CONFIG`` before the first cuBLAS call), so the steps
replayed after the crash can give the first run's losses bit for bit.
``--verify`` keeps a device copy of each saved state and checks both
claims — the restored state is the saved one, bit for bit, every leaf
with ``count`` and ``step``; the replayed steps' losses are the first
run's — prints them as a ``{"resume": ...}`` JSON line with the save and
restore wall and simulated seconds and the peak RSS, and exits non-zero
when either fails.
"""
import argparse
import dataclasses
import json
import os
import resource
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import (SyntheticLMDataset,  # noqa: E402
                              make_batch_iterator)
from repro_torch.models import LM  # noqa: E402
from repro_torch.training import (AdamWConfig,  # noqa: E402
                                  init_train_state, make_train_step)

SAVE_EVERY = 10


def build_100m(num_layers: int = 10):
    """A ~100M-parameter internlm2-family config (the reference example's),
    at ``num_layers`` layers."""
    base = get_config("internlm2-1.8b")
    return dataclasses.replace(
        base, name="internlm2-100m", num_layers=num_layers, d_model=768,
        num_heads=12, num_kv_heads=4, d_ff=3072, vocab_size=16384,
        head_dim=64)


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
    return out


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="simulate a crash at this step (default: midway)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=10)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--verify", action="store_true")
    args = ap.parse_args(argv)
    # crash only after at least one checkpoint exists
    crash_at = args.crash_at or max(args.steps // 2, 11)
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)

    cfg = build_100m(args.layers)
    model = LM(cfg, device=args.device, remat=True)
    dev = model.device
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"({cfg.num_layers} layers)")
    opt = AdamWConfig(lr=1e-3, schedule="cosine",
                      warmup_steps=args.steps // 20, total_steps=args.steps)
    step_fn = make_train_step(model, opt)
    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch, seed=0)
    print(f"synthetic-data loss floor ≈ {ds.entropy_floor:.3f} nats")

    mgr = CheckpointManager("log", nvmm_bytes=2 << 30, snapshot_every=4)
    state = init_train_state(model, torch.Generator(dev).manual_seed(0))
    it = make_batch_iterator(ds)
    saved, losses, replayed = {}, {}, {}
    saves, restore = [], None
    t0 = time.time()
    step = 0
    crashed = False
    while step < args.steps:
        state, metrics = step_fn(state, next(it))
        step += 1
        if args.verify:
            (replayed if crashed else losses)[step] = float(metrics["loss"])
        if step % 20 == 0 or step == 1:
            print(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e}")
        if step % SAVE_EVERY == 0:
            ts = time.perf_counter()
            sim = mgr.save(step, state)
            wall = time.perf_counter() - ts
            saves.append({"step": step, "wall_s": wall, "sim_s": sim})
            print(f"  ckpt[log] step {step}: {wall:.3f} s wall, "
                  f"{sim:.6f} s simulated")
            if args.verify:
                saved = {step: {k: t.detach().clone() for k, t in
                                _leaves(state).items()}}
        if step == crash_at and not crashed:
            print(f"*** simulated crash at step {step} "
                  f"(power loss: volatile state dropped) ***")
            mgr.crash()
            sim0 = mgr.fs.simulated_time
            ts = time.perf_counter()
            restored_step, state = mgr.restore(state)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            restore = {"step": restored_step,
                       "wall_s": time.perf_counter() - ts,
                       "sim_s": mgr.fs.simulated_time - sim0}
            if args.verify:
                want = saved[restored_step]
                got = _leaves(state)
                restore["leaves"] = len(got)
                restore["bit_equal"] = sorted(got) == sorted(want) and all(
                    _same_bits(got[k], want[k]) for k in want)
                saved.clear()
            print(f"*** recovered via log replay → resuming at step "
                  f"{restored_step} ({restore['wall_s']:.3f} s wall, "
                  f"{restore['sim_s']:.6f} s simulated) ***")
            step = restored_step
            crashed = True
            it = make_batch_iterator(ds, start_step=step)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU")
    print(f"done in {dt:.1f}s ({toks/dt:.0f} tok/s on {where}); final loss "
          f"{float(metrics['loss']):.4f} vs floor {ds.entropy_floor:.3f}")
    if not args.verify:
        return 0
    again = sorted(s for s in replayed if s in losses)
    result = {
        "steps": args.steps, "crash_at": crash_at, "saves": saves,
        "restore": restore, "replayed_steps": again,
        "replay_bit_equal": bool(again) and all(
            replayed[s] == losses[s] for s in again),
        "losses": losses, "replayed": replayed, "wall_s": dt,
        "peak_rss_gib": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
        "deterministic": args.deterministic}
    print(json.dumps({"resume": result}))
    ok = restore is not None and restore["bit_equal"] and \
        result["replay_bit_equal"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
