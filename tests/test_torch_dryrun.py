"""The port's dry run in a subprocess, on fake worlds of 4 and 8 ranks
(``REPRO_TEST_MESH`` 2x2 and 2x2x2, ``--device cpu``): the reference's
four smoke cells (``tests/test_dryrun_small.py``) and its multipod cell.
Each artifact has the reference's keys (``fits_hbm`` for its
``fits_v5e_hbm``, ``run_s`` for its ``compile_s``), and its
``argument_bytes`` equals the sum over the JAX package's leaves of their
local shard bytes, computed here from the JAX specs of the same cell. One
dtype differs, deliberately: the port stores every parameter once in the
compute dtype (bf16 here), where the reference keeps SSM's ``dt_bias``,
``a_log`` and ``d_skip`` in fp32 and casts them on every call; those
leaves count at bf16's width (the reference's train state stores them in
bf16 as well)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import SHAPES_BY_NAME, get_config
from repro.distributed import sharding as JS
from repro.launch import specs as JSP
from repro.models import build_model

REPO = Path(__file__).resolve().parent.parent
AXES = ("pod", "data", "model")
CELLS = [("internlm2-1.8b-smoke", "train_4k", "single", "2x2"),
         ("deepseek-v2-236b-smoke", "train_4k", "single", "2x2"),
         ("mamba2-1.3b-smoke", "decode_32k", "single", "2x2"),
         ("zamba2-1.2b-smoke", "decode_32k", "single", "2x2"),
         ("internlm2-1.8b-smoke", "train_4k", "multi", "2x2x2")]
KEYS = {"arch", "shape", "mesh", "devices", "kind",
        "kv_cache_dtype", "lower_s", "run_s", "memory",
        "per_device_live_bytes", "fits_hbm", "cost", "collectives"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "generated_code_bytes", "alias_bytes"}


def _run(args, mesh):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               REPRO_TEST_MESH=mesh)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "cpu", *args], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=600)


def _local_bytes(leaf, spec, sizes) -> int:
    n = 1
    entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
    for dim, entry in zip(leaf.shape, entries):
        axes = JS._axes_of(entry)
        n *= dim // int(np.prod([sizes[a] for a in axes])) if axes else dim
    return n * np.dtype(leaf.dtype).itemsize


def _tree_bytes(shapes, specs, sizes) -> int:
    import jax
    from jax.sharding import PartitionSpec as P
    leaves = jax.tree.leaves(shapes)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return sum(_local_bytes(l, s, sizes) for l, s in zip(leaves, spec_leaves))


def jax_argument_bytes(arch, shape_name, mesh_dims, mb, layers=None) -> int:
    """The local bytes of the JAX cell's arguments on one device: the
    train state and batch, the params and batch (prefill), or the params,
    cache, tokens and positions (decode);
    ``layers`` cuts the depth as the reference's ``--layers`` does."""
    import dataclasses

    from jax.sharding import PartitionSpec as P
    axes = AXES[-len(mesh_dims):]
    mesh = JS.make_abstract_mesh(mesh_dims, axes)
    sizes = dict(zip(axes, mesh_dims))
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(
            cfg, num_layers=layers,
            num_encoder_layers=min(cfg.num_encoder_layers, layers))
        if cfg.hybrid is not None:
            cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(
                cfg.hybrid, shared_block_period=max(layers // 2, 1)))
    shape = SHAPES_BY_NAME[shape_name]
    model = build_model(cfg, param_dtype=jnp.bfloat16,
                        compute_dtype=jnp.bfloat16)
    if shape.kind == "train":
        moment = jnp.bfloat16 if cfg.param_count() > 60e9 else jnp.float32
        state = JSP.abstract_state(model, moment)
        total = _tree_bytes(state, JSP.state_specs(state, cfg, mesh), sizes)
        batch = JSP.input_specs(cfg, shape, microbatches=mb)
        over = None
        if cfg.family in ("ssm", "hybrid"):
            da = JS.data_axes(mesh)
            for cand in (da + ("model",), ("data", "model"), da, ("data",)):
                cand = tuple(a for a in cand if a in axes)
                if cand and shape.global_batch % int(
                        np.prod([sizes[a] for a in cand])) == 0:
                    over = cand
                    break
        return total + _tree_bytes(batch, JS.batch_specs(
            batch, mesh, microbatched=mb > 1, dp_override=over), sizes)
    import jax
    params = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, jnp.bfloat16)
        if a.dtype == jnp.float32 else a, JSP.abstract_params(model))
    total = _tree_bytes(params, JS.param_specs(params, cfg, mesh), sizes)
    if shape.kind == "prefill":
        batch = JSP.input_specs(cfg, shape)
        return total + _tree_bytes(batch, JS.batch_specs(batch, mesh), sizes)
    cache = JSP.abstract_cache(model, cfg, shape)
    total += _tree_bytes(cache, JS.cache_specs(cache, cfg, mesh), sizes)
    batch = JSP.input_specs(cfg, shape)
    total += _tree_bytes(batch, JS.batch_specs(batch, mesh), sizes)
    dp = JS.data_axes(mesh)
    dp_size = int(np.prod([sizes[a] for a in dp]))
    pos_spec = P(dp) if shape.global_batch % dp_size == 0 else P()
    pos = jnp.zeros((shape.global_batch,), jnp.int32)
    return total + _local_bytes(pos, pos_spec, sizes)


@pytest.mark.parametrize("arch,shape,mesh,dims", CELLS)
def test_dryrun_cell_artifact(arch, shape, mesh, dims, tmp_path):
    r = _run(["--arch", arch, "--shape", shape, "--mesh", mesh, "--out",
              str(tmp_path)], dims)
    assert r.returncode == 0, r.stdout + r.stderr
    arts = list(tmp_path.glob("*.json"))
    assert len(arts) == 1
    data = json.loads(arts[0].read_text())
    keys = KEYS | ({"microbatches"} if shape.startswith("train") else set())
    assert keys <= set(data), keys - set(data)
    assert set(data["memory"]) == MEMORY_KEYS
    assert {"flops", "bytes accessed"} <= set(data["cost"])
    assert {"total_wire_bytes", "num_ops"} <= set(data["collectives"])
    assert data["mesh"] == ("multipod" if mesh == "multi" else "pod")
    mesh_dims = tuple(int(x) for x in dims.split("x"))
    assert data["devices"] == int(np.prod(mesh_dims))
    assert data["collectives"]["num_ops"] > 0
    assert data["per_device_live_bytes"] == (
        data["memory"]["argument_bytes"] + data["memory"]["temp_bytes"])
    assert data["cost"]["flops"] > 0
    assert data["memory"]["argument_bytes"] == jax_argument_bytes(
        arch, shape, mesh_dims, data.get("microbatches", 1))
    if arch.startswith("deepseek"):
        # the EP path: the FSDP'd expert hidden dim gathered a layer
        assert data["collectives"]["all-gather"]["count"] >= 3


def test_unroll_is_accepted_and_says_it_does_nothing():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--help"], capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                       timeout=120)
    assert r.returncode == 0
    text = " ".join(r.stdout.split())
    assert "--unroll" in text and "does nothing" in text
    assert "--device" in text
