"""Multi-pod dry run: step every (architecture × input-shape × mesh) cell
on fake tensors over a fake 256- or 512-rank world, and record one rank's
memory, cost and collectives for the roofline analysis.

The port's counterpart of the JAX package's ``launch/dryrun.py``. Where
the reference lowers and compiles each cell for 512 host devices, this
runs it: PyTorch's ``fake`` process group plays rank 0 of the mesh's
world (its collectives move nothing), the model and its state are fake
tensors on the run's device (shapes and dtypes, no storage) placed as
DTensors by the reference's sharding rules, and the step the reference
lowers runs once — the train step (microbatched, accumulation and moment
dtypes as the reference picks), ``LM.prefill``, or ``LM.decode_step`` over
the cache ``prefill`` gives — inside ``implicit_replication()`` and a
:class:`~repro_torch.roofline.comms.CostMode`, which counts the rank's
collectives, operations (``torch.utils.flop_counter``'s formulas; #9 is a
custom op with its own), bytes accessed and peak live bytes.

The artifact keeps the reference's keys: ``memory.argument_bytes`` (the
local bytes of the step's inputs), ``memory.temp_bytes`` (the most bytes
the step's own allocations hold at once), ``per_device_live_bytes``
(their sum), ``cost.flops`` and ``cost["bytes accessed"]`` per rank,
``collectives`` and ``fits_hbm`` (against the H100's 80 GB).

``fits_hbm`` is ``per_device_live_bytes <= 80e9`` and keeps no margin of
its own. The live bytes are what the step's tensors hold, as the eager
run allocates them (``CostMode``); the card's allocator adds cuBLAS's
workspace and its rounding. On a real one-card run of two cut cells
(``chip_smoke.py`` phase 36: InternLM2-1.8B at 2 layers, train_4k at
batch 4 and prefill_32k at batch 1) ``torch.cuda.max_memory_allocated``
read 1.001× and 1.020× the prediction (NVIDIA H100 80GB HBM3, 700.00 W),
and the phase fails outside 0.95–1.10. Not counted: the allocator's
fragmentation (reserved above allocated) and the communication
library's own buffers; the 80 GB is 5 GB under the card's
``total_memory`` (85.0 GB).

Usage:
    python -m repro_torch.launch.dryrun --arch starcoder2-15b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both \
        --out artifacts/dryrun_torch
    python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k \
        --layers 2
    REPRO_TEST_MESH=2x2 python -m repro_torch.launch.dryrun --device cpu \\
        --arch internlm2-1.8b-smoke --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.configs import (ARCH_IDS, SHAPES_BY_NAME, applicable_shapes,
                                 get_config, skipped_shapes)
from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                              data_axes, local_bytes,
                                              param_specs)
from repro_torch.launch.mesh import (make_test_mesh, prepare_groups,
                                     production_mesh_shape, start_fake_world)
from repro_torch.launch.specs import (abstract_cache, abstract_params,
                                      abstract_state, input_specs,
                                      install_params, state_specs,
                                      with_shardings)
from repro_torch.models import LM
from repro_torch.roofline.comms import CostMode
from repro_torch.roofline.hw import H100
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.step import make_train_step

ACTIVATION_BUDGET = 4e9        # bytes/device of per-layer saved residuals


def _size(mesh, axes) -> int:
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)


def pick_microbatches(cfg, shape, mesh) -> int:
    dp = _size(mesh, data_axes(mesh))
    if cfg.family in ("ssm", "hybrid"):
        dp *= _size(mesh, ("model",))     # model axis folded into batch
    b_loc = max(shape.global_batch // dp, 1)
    layers = cfg.num_layers + cfg.num_encoder_layers
    act = b_loc * shape.seq_len * cfg.d_model * 2 * max(layers, 1)
    mb = 1
    while act / mb > ACTIVATION_BUDGET and mb < b_loc:
        mb *= 2
    return mb


def moment_dtype_for(cfg):
    # 100B+ models need bf16 moments to fit in device memory
    return torch.bfloat16 if cfg.param_count() > 60e9 else torch.float32


def cut_config(arch: str, layers_override=None, period_override=None):
    """The arch's config, its depth cut to ``layers_override`` (the
    hybrid's shared-block period to ``period_override`` or half of it), as
    the reference cuts it."""
    cfg = get_config(arch)
    if layers_override:
        cfg = dataclasses.replace(cfg, num_layers=layers_override,
                                  num_encoder_layers=min(
                                      cfg.num_encoder_layers, layers_override))
        if cfg.hybrid is not None:
            period = period_override or max(layers_override // 2, 1)
            cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(
                cfg.hybrid, shared_block_period=period))
    return cfg


def lower_cell(arch: str, shape_name: str, mesh, layers_override=None,
               chunk_size: int = 512, mb_override=None, period_override=None,
               kv_cache_dtype: str = "native", device="cuda",
               batch_override=None):
    """Build one cell on ``mesh``: returns ``(step, args, meta)``,
    ``step()`` running the cell's step on ``args`` (the DTensor inputs,
    name → tensor or tree). The caller holds the fake mode (the dry run;
    without one the tensors are real and uninitialised) and the world of
    the mesh's size, and builds the mesh outside the fake mode.
    ``batch_override`` cuts the shape's global batch."""
    cfg = cut_config(arch, layers_override, period_override)
    shape = SHAPES_BY_NAME[shape_name]
    if batch_override:
        shape = dataclasses.replace(shape, global_batch=batch_override)
    kind = shape.kind
    ep = data_axes(mesh) if cfg.moe is not None else ()

    if kind == "train":
        model = LM(cfg, dtype=torch.bfloat16, device=device, remat=True,
                   chunk_size=chunk_size, ep_axes=ep)
        mb = mb_override or pick_microbatches(cfg, shape, mesh)
        state = abstract_state(model, moment_dtype_for(cfg))
        state = with_shardings(state, state_specs(state, model, mesh), mesh)
        state["params"] = install_params(model, state.params, True)
        batch = input_specs(cfg, shape, microbatches=mb, device=device)
        # SSM/hybrid backbones have no TP mapping for the mixer weights:
        # fold the model axis into batch (the largest axis combination
        # that divides the global batch)
        dp_override = None
        if cfg.family in ("ssm", "hybrid"):
            da = data_axes(mesh)
            for cand in (da + ("model",), ("data", "model"), da, ("data",)):
                cand = tuple(a for a in cand if a in mesh.mesh_dim_names)
                if cand and shape.global_batch % _size(mesh, cand) == 0:
                    dp_override = cand
                    break
        batch = with_shardings(batch, batch_specs(
            batch, mesh, microbatched=mb > 1, dp_override=dp_override), mesh)
        accum_dtype = (torch.bfloat16 if cfg.param_count() > 60e9
                       else torch.float32)
        step = make_train_step(model, AdamWConfig(), microbatches=mb,
                               accum_dtype=accum_dtype)
        return (lambda: step(state, batch), {"state": state, "batch": batch},
                {"microbatches": mb, "kind": kind})

    model = LM(cfg, dtype=torch.bfloat16, device=device, remat=False,
               chunk_size=chunk_size, kv_cache_dtype=kv_cache_dtype,
               ep_axes=ep)
    if kind == "prefill":
        params = with_shardings(abstract_params(model),
                                param_specs(model, mesh), mesh)
        params = install_params(model, params, False)
        batch = input_specs(cfg, shape, device=device)
        batch = with_shardings(batch, batch_specs(batch, mesh), mesh)
        return (lambda: model.prefill(
                    batch["tokens"], shape.seq_len,
                    frontend_embeds=batch.get("frontend_embeds")),
                {"params": params, "batch": batch}, {"kind": kind})

    # decode: one token against an S-token cache
    with torch.no_grad():
        cache = abstract_cache(model, cfg, shape)
    cache = with_shardings(cache, cache_specs(cache, cfg, mesh), mesh)
    params = with_shardings(abstract_params(model),
                            param_specs(model, mesh), mesh)
    params = install_params(model, params, False)
    batch = input_specs(cfg, shape, device=device)
    batch = with_shardings(batch, batch_specs(batch, mesh), mesh)
    # positions batch-sharded where the data axes divide the batch
    pos_spec = batch_specs({"pos": (shape.global_batch,)}, mesh)["pos"]
    pos = with_shardings(torch.empty((shape.global_batch,), dtype=torch.int32,
                                     device=device), pos_spec, mesh)
    return (lambda: model.decode_step(cache, batch["tokens"], pos),
            {"params": params, "cache": cache, "tokens": batch["tokens"],
             "pos": pos}, {"kind": kind})


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def measure_cell(step, args, ops=None) -> dict:
    """Run ``step()`` once inside ``implicit_replication`` and a
    ``CostMode``; returns the artifact's memory, cost and collectives
    (and appends each collective to the list ``ops``, when given)."""
    from torch.distributed.tensor.experimental import implicit_replication
    arg_leaves = _leaves(args)
    arg_bytes = sum(local_bytes(t) for t in arg_leaves)
    arg_ids = {id(t) for t in arg_leaves}
    with implicit_replication(), CostMode() as cm:
        out = step()
        out_leaves = _leaves(out)
        del out
    if ops is not None:
        ops.extend(dataclasses.asdict(op) for op in cm.collectives)
    out_bytes = sum(local_bytes(t) for t in out_leaves)
    alias = sum(local_bytes(t) for t in out_leaves if id(t) in arg_ids)
    mem = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
           "temp_bytes": cm.peak_bytes, "generated_code_bytes": None,
           "alias_bytes": alias}
    live = arg_bytes + cm.peak_bytes
    return {"memory": mem, "per_device_live_bytes": live,
            "fits_hbm": bool(live <= H100.hbm_bytes),
            "cost": {"flops": float(cm.flops),
                     "bytes accessed": float(cm.bytes_accessed)},
            "collectives": cm.summary()}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             layers_override=None, keep_hlo: bool = False, mb_override=None,
             period_override=None, kv_cache_dtype: str = "native",
             chunk_size: int = 512, device="cuda", batch_override=None,
             mesh_shape=None) -> dict:
    """One cell on a fresh fake world of the mesh's size (the production
    mesh, or ``mesh_shape`` = ``(sizes, axis names)``); writes
    ``<out_dir>/<arch>__<shape>__<pod|multipod>[__L<n>[P<p>]][__B<b>].json``
    and returns its contents. ``keep_hlo`` (the reference keeps the
    compiled HLO) writes the run's collectives one by one beside it,
    ``<tag>.collectives.json``: the port has no HLO."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh_name = "multipod" if multi_pod else "pod"
    tag = f"{arch}__{shape_name}__{mesh_name}"
    if layers_override:
        tag += f"__L{layers_override}"
    if period_override:
        tag += f"P{period_override}"
    if kv_cache_dtype != "native":
        tag += f"__kv{kv_cache_dtype}"
    if batch_override:
        tag += f"__B{batch_override}"
    shape, axes = mesh_shape or production_mesh_shape(multi_pod)
    start_fake_world(math.prod(shape))
    t0 = time.time()
    # the mesh and its groups read its rank map: built outside the fake
    # mode
    mesh = make_test_mesh(shape, axes, torch.device(device).type)
    prepare_groups(mesh)
    with FakeTensorMode():
        step, args, meta = lower_cell(
            arch, shape_name, mesh, layers_override, chunk_size=chunk_size,
            mb_override=mb_override, period_override=period_override,
            kv_cache_dtype=kv_cache_dtype, device=device,
            batch_override=batch_override)
        t_lower = time.time() - t0
        t0 = time.time()
        ops = [] if keep_hlo else None
        res = measure_cell(step, args, ops)
        t_run = time.time() - t0
    meta["kv_cache_dtype"] = kv_cache_dtype
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "mesh_shape": list(shape), "devices": math.prod(shape),
              "device_type":
              torch.device(device).type, **meta,
              "lower_s": round(t_lower, 2), "run_s": round(t_run, 2), **res}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(result, indent=1))
    if keep_hlo:
        (out_dir / f"{tag}.collectives.json").write_text(json.dumps(ops))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Step every (arch x shape x mesh) cell on fake tensors "
                    "over a fake 256/512-rank world; one JSON artifact a "
                    "cell.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--layers", type=int, default=None,
                    help="override depth (roofline L-differencing)")
    ap.add_argument("--mb", type=int, default=None,
                    help="override train microbatch count")
    ap.add_argument("--period", type=int, default=None,
                    help="override hybrid shared-block period (roofline)")
    ap.add_argument("--unroll", action="store_true",
                    help="accepted for the reference's CLI and does "
                         "nothing: the port loops layers in Python, so "
                         "every layer is run and counted (there is no scan "
                         "to unroll)")
    ap.add_argument("--kv-dtype", default="native",
                    choices=("native", "int8"),
                    help="KV-cache dtype for decode cells")
    ap.add_argument("--chunk", type=int, default=512,
                    help="attention chunk size: prompts past it run #9")
    ap.add_argument("--keep-hlo", action="store_true",
                    help="the port has no HLO: write each collective of the "
                         "run beside the artifact (<tag>.collectives.json)")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda unless "
                         "--device cpu; nothing is allocated either way)")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))   # raises without the card

    out_dir = Path(args.out)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([SHAPES_BY_NAME[args.shape]] if args.shape
                  else applicable_shapes(cfg))
        for sh in shapes:
            for mp in meshes:
                tag = f"{arch} × {sh.name} × {'multipod' if mp else 'pod'}"
                try:
                    r = run_cell(arch, sh.name, mp, out_dir,
                                 layers_override=args.layers,
                                 keep_hlo=args.keep_hlo,
                                 mb_override=args.mb,
                                 period_override=args.period,
                                 kv_cache_dtype=args.kv_dtype,
                                 chunk_size=args.chunk, device=device)
                    print(f"[ok] {tag}: live="
                          f"{r['per_device_live_bytes'] / 1e9:.2f}GB"
                          f" fits={r['fits_hbm']}"
                          f" colls={r['collectives'].get('num_ops', 0)}"
                          f" run={r['run_s']}s", flush=True)
                except Exception as e:  # noqa: BLE001 — one cell's failure
                    failures += 1       # is reported; the sweep goes on
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}",
                          flush=True)
                    traceback.print_exc()
        for sh_name, reason in (skipped_shapes(cfg) if not args.shape else []):
            print(f"[skip] {arch} × {sh_name}: {reason}", flush=True)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
