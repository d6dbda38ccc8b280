#!/usr/bin/env python3
"""The port's model and its expert-parallel MoE on a 2 × 2 (data × model)
mesh of four real ranks, held against the same weights as plain tensors.

    python3 scripts/dtensor_mesh_check.py [--device cuda|cpu]

One process a rank: on the card four GPUs over ``nccl`` (needs four), on
the CPU four processes over ``gloo``. At smoke widths in fp32, each rank
builds the same seeded model twice, places one copy's weights as
DTensors by the sharding rules, and compares, on the full tensors:

* the loss (vocab-parallel cross-entropy; past ``chunk_size`` #9 through
  its custom op's sharding rule, heads on ``model``), the prefill's last
  logits (vocab-parallel embedding) and one decode step over the
  sequence-sharded cache (the LSE merge), for InternLM2 with 4 KV heads,
  with 1 KV head and an int8 cache (the head gather), and DeepSeek-V2
  (MLA's latent cache; MoE through the EP path) at no-drop capacity;
* ``apply_moe`` on a DeepSeek-V2 MoE layer, experts on ``model`` and
  their hidden dim on ``data``: ``_moe_ep`` at 4400 tokens and
  ``_moe_ep_tokengather`` at 64, against the single-device path, at
  no-drop capacity (``_moe_ep``'s aux loss against the mean of each data
  shard's, as the reference computes it).

Tolerance: 1e-5 absolute and relative (the ranks' partial sums add in
another order). Prints, on the card, each card's name and power limit;
then a line per case with its largest difference, and last a JSON object
of them. Exits 1 on a mismatch. ``tests/test_torch_sharding.py`` runs
each case on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
# (name, arch, config overrides, KV-cache dtype); capacity_factor None:
# no-drop (the expert count); MLA's no-rope width 16, so its (qk, v) head
# widths are (32, 32), a pair #9 is built for (the smoke config's 48, 32
# is not)
MODEL_CASES = (("internlm2 4 KV heads", "internlm2-1.8b",
                {"num_kv_heads": 4}, "native"),
               ("internlm2 1 KV head int8", "internlm2-1.8b",
                {"num_kv_heads": 1}, "int8"),
               ("deepseek-v2 MLA + EP", "deepseek-v2-236b",
                {"capacity_factor": None, "qk_nope_head_dim": 16}, "native"))
# (EP path apply_moe takes, x's (batch, sequence))
EP_CASES = (("_moe_ep", (2, 2200)), ("_moe_ep_tokengather", (64, 1)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def model_cfg(arch, overrides):
    """The arch's smoke config with ``overrides``, each on the config or
    on its ``moe``/``mla`` part; ``capacity_factor`` None is no-drop."""
    from repro_torch.configs import get_config
    cfg = get_config(arch + "-smoke")
    overrides = dict(overrides)
    if "capacity_factor" in overrides and overrides["capacity_factor"] is None:
        overrides["capacity_factor"] = float(cfg.moe.num_experts)
    for part in ("moe", "mla"):
        sub = getattr(cfg, part)
        names = {f.name for f in dataclasses.fields(sub)} if sub else ()
        mine = {k: overrides.pop(k) for k in list(overrides) if k in names}
        if mine:
            cfg = dataclasses.replace(
                cfg, **{part: dataclasses.replace(sub, **mine)})
    return dataclasses.replace(cfg, **overrides)


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def model_run(torch, mesh, dev, arch, overrides, kv_dtype):
    """``{"plain": [loss, logits, decode], "dtensor": [...]}`` as numpy
    arrays, the DTensor run's gathered whole."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                                  data_axes, param_specs)
    from repro_torch.launch.specs import install_params, with_shardings
    from repro_torch.models import LM
    cfg = model_cfg(arch, overrides)
    ep = data_axes(mesh) if cfg.moe is not None else ()
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 24), generator=g,
                           dtype=torch.int32).to(dev)
    nxt = torch.randint(0, cfg.vocab_size, (4, 1), generator=g,
                        dtype=torch.int32).to(dev)
    res = {}
    for kind in ("plain", "dtensor"):
        model = LM(cfg, device=dev, chunk_size=16, kv_cache_dtype=kv_dtype,
                   ep_axes=ep).init(torch.Generator(dev).manual_seed(1))
        batch = {"tokens": tokens, "labels": tokens}
        toks, step = tokens, nxt
        if kind == "dtensor":
            install_params(model, with_shardings(
                dict(model.named_parameters()), param_specs(model, mesh),
                mesh), False)
            batch = with_shardings(batch, batch_specs(batch, mesh), mesh)
            toks, step = batch["tokens"], with_shardings(
                nxt, batch_specs({"t": nxt}, mesh)["t"], mesh)
        with implicit_replication(), torch.no_grad():
            loss = model.loss_fn(batch)[0]
            logits, cache = model.prefill(toks, 32)
            pos = cache.pop("pos")
            if kind == "dtensor":
                cache = with_shardings(
                    {k: _whole(v) for k, v in cache.items()},
                    cache_specs(cache, cfg, mesh), mesh)
                pos = with_shardings(_whole(pos), batch_specs(
                    {"p": pos}, mesh)["p"], mesh)
            cache["pos"] = pos
            dec, _ = model.decode_step(cache, step, pos)
        res[kind] = [_whole(t).cpu().numpy() for t in (loss, logits, dec)]
    return res


def ep_run(torch, mesh, dev, path, shape):
    """``apply_moe`` on a DeepSeek-V2 smoke MoE layer: ``{"plain": [y,
    aux], "dtensor": [...]}`` at no-drop capacity."""
    from types import SimpleNamespace

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import P, distribute
    from repro_torch.models import blocks as B
    from repro_torch.models.moe import apply_moe
    cfg = model_cfg("deepseek-v2-236b", {"capacity_factor": None})
    blk = B.DecoderBlock(cfg, torch.float32, dev, "moe")
    blk.init_weights(torch.Generator(dev).manual_seed(2))
    specs = {"router": P(None, None),
             "experts.w_gate": P("model", None, "data"),
             "experts.w_up": P("model", None, "data"),
             "experts.w_down": P("model", "data", None),
             "shared.w_gate": P(None, "model"),
             "shared.w_up": P(None, "model"),
             "shared.w_down": P("model", None)}
    d = distribute({n: blk.get_parameter(n).detach() for n in specs},
                   specs, mesh)
    dt = SimpleNamespace(
        router=d["router"], ffn_kind="moe",
        experts=SimpleNamespace(**{n: d["experts." + n] for n in
                                   ("w_gate", "w_up", "w_down")}),
        shared=SimpleNamespace(**{n: d["shared." + n] for n in
                                  ("w_gate", "w_up", "w_down")}))
    x = torch.randn(shape + (cfg.d_model,),
                    generator=torch.Generator().manual_seed(3)).to(dev)
    xd = distribute({"x": x}, {"x": P("data", None, None)}, mesh)["x"]
    with torch.no_grad():
        with implicit_replication():
            y, aux = apply_moe(dt, cfg, xd, ("data",))
        y0, aux0 = apply_moe(blk, cfg, x)
        if path == "_moe_ep":
            # each data shard's aux loss, then their mean (the
            # reference's): the loss is not linear in the tokens
            aux0 = torch.stack([apply_moe(blk, cfg, part)[1]
                                for part in x.chunk(2)]).mean()
    return {"dtensor": [_whole(t).cpu().numpy() for t in (y, aux)],
            "plain": [t.cpu().numpy() for t in (y0, aux0)]}


def rank_main(rank, port, out, device, cases):
    """One rank: the 2 × 2 mesh over ``nccl`` (GPU ``rank``) or ``gloo``;
    runs ``cases`` (``("model", name)`` or ``("ep", path)``); rank 0
    writes each case's arrays to ``out`` (``.npz``)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    dev = torch.device(device, rank) if device == "cuda" else \
        torch.device("cpu")
    if device == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port}", rank=rank, world_size=4,
        timeout=datetime.timedelta(seconds=300),
        **({"device_id": dev} if device == "cuda" else {}))
    try:
        mesh = make_test_mesh((2, 2), device_type=device)
        models = {c[0]: c[1:] for c in MODEL_CASES}
        eps = dict(EP_CASES)
        arrays = {}
        for kind, name in cases:
            res = (model_run(torch, mesh, dev, *models[name])
                   if kind == "model" else
                   ep_run(torch, mesh, dev, name, eps[name]))
            for k, v in res.items():
                for i, a in enumerate(v):
                    arrays[f"{name}|{k}|{i}"] = a
        if rank == 0:
            np.savez(out, **arrays)
    finally:
        dist.destroy_process_group()


def run_cases(device, cases, out) -> dict:
    """Run ``cases`` on four ranks; returns ``{name: largest |dtensor -
    plain|}`` and raises where one lies outside ``TOL``."""
    import torch.multiprocessing as mp
    mp.start_processes(rank_main, args=(free_port(), str(out), device,
                                        tuple(cases)),
                       nprocs=4, start_method="spawn", join=True)
    r = np.load(out)
    worst = {}
    for _, name in cases:
        n = sum(1 for k in r.files if k.startswith(f"{name}|plain|"))
        for i in range(n):
            got, want = r[f"{name}|dtensor|{i}"], r[f"{name}|plain|{i}"]
            np.testing.assert_allclose(got, want, **TOL,
                                       err_msg=f"{name} output {i}")
            assert np.isfinite(want).all(), f"{name} output {i}"
            worst[name] = max(worst.get(name, 0.0),
                              float(np.abs(got - want).max()))
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="build/dtensor_mesh_check.npz")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if torch.cuda.device_count() < 4:
            print("dtensor_mesh_check: needs four CUDA GPUs",
                  file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    cases = [("model", c[0]) for c in MODEL_CASES] + \
        [("ep", c[0]) for c in EP_CASES]
    try:
        worst = run_cases(args.device, cases, out)
    except AssertionError as e:
        print(f"dtensor_mesh_check: mismatch: {e}", file=sys.stderr)
        return 1
    for name, w in worst.items():
        print(f"[{args.device} 2x2] {name}: largest |dtensor - plain| "
              f"{w:.3e} ({'bit for bit' if w == 0 else 'within 1e-5'})")
    print(json.dumps(worst))
    return 0


if __name__ == "__main__":
    sys.exit(main())
