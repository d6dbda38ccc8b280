"""The port's sharding rules against the JAX package's: for every arch on
both production meshes, each port tensor's spec equals its JAX leaf's —
``param_specs``, ``zero1_specs`` (master, mu and nu share it),
``batch_specs`` (plain and microbatched) and ``cache_specs`` — with the
layer axes removed; ``to_placements`` cuts each rank's shard where JAX's
layout does on a 2×2×2 mesh; and a DTensor model on a real 4-rank
``gloo`` mesh computes what the plain model computes.

The one deliberate difference (ROADMAP §3): where ZeRO-1 puts the data
axes on a stacked leaf's layer axis, the port's per-layer tensor takes
them on its own first evenly-divisible unsharded dim (the same bytes a
rank). Specs are computed from shapes alone: the port's full-size models
are built on the ``meta`` device and the JAX ones by ``eval_shape``.
"""
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, SHAPES_BY_NAME as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.distributed import sharding as JS
from repro.launch import specs as JSP
from repro.models import build_model
from repro_torch.configs import applicable_shapes, get_config
from repro_torch.distributed import sharding as S
from repro_torch.launch import specs as PSP
from repro_torch.models import LM

REPO = Path(__file__).resolve().parent.parent
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(JS._path_names(p)): v for p, v in leaves}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    model = build_model(jax_config(arch), param_dtype=jnp.bfloat16,
                        compute_dtype=jnp.bfloat16)
    return JSP.abstract_params(model)


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    return LM(get_config(arch), dtype=torch.bfloat16, device="meta")


def _meshes(name):
    shape, axes = MESHES[name]
    return JS.make_abstract_mesh(shape, axes), S.AbstractMesh(shape, axes)


def _drop(spec, n_layer, ndim):
    entries = list(spec) + [None] * (n_layer + ndim - len(spec))
    return tuple(entries[n_layer:])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_zero1_specs_are_the_references(arch, mesh):
    jm, pm = _meshes(mesh)
    jparams = _jax_params(arch)
    jspec = _flat(JS.param_specs(jparams, None, jm))
    jz = _flat(JS.zero1_specs(jparams, None, jm))
    model = _port_model(arch)
    leaves = S.jax_leaves(model)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert set(leaves) == set(shapes)
    # every JAX leaf's numbers are the port's tensors' numbers
    jsizes = {path: int(np.prod(leaf.shape)) for path, leaf in
              _flat(jparams).items()}
    per_path: dict = {}
    for n, (path, layers) in leaves.items():
        per_path[path] = per_path.get(path, 0) + int(np.prod(shapes[n]))
    assert per_path == jsizes
    pspec, pz = S.param_specs(model, pm), S.zero1_specs(model, pm)
    dp = S.data_axes(pm)
    dp_size = int(np.prod([pm.shape[a] for a in dp]))
    layer_sharded = 0
    for n, (path, layers) in leaves.items():
        nd = len(shapes[n])
        assert tuple(pspec[n]) == _drop(jspec[path], len(layers), nd), n
        want = _drop(jz[path], len(layers), nd)
        full = list(jz[path]) + [None] * (len(layers) + nd - len(jz[path]))
        if any(full[:len(layers)]):
            # JAX shards the layer axis: the port's own first divisible
            # unsharded dim takes the data axes instead
            layer_sharded += 1
            own = list(want)
            i = next((i for i, (e, d) in enumerate(zip(own, shapes[n]))
                      if e is None and d % dp_size == 0), None)
            if i is not None:
                own[i] = dp if len(dp) > 1 else dp[0]
            want = tuple(own)
        assert tuple(pz[n]) == want, n
    if arch == "mamba2-1.3b" and mesh == "pod":
        assert layer_sharded           # 48 layers on a 16-way data axis


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_are_the_references(arch, mesh):
    jm, pm = _meshes(mesh)
    for shape in applicable_shapes(get_config(arch)):
        for mb in (1, 2) if shape.kind == "train" else (1,):
            jb = JSP.input_specs(jax_config(arch), JAX_SHAPES[shape.name],
                                 microbatches=mb)
            with torch.device("meta"):
                pb = PSP.input_specs(get_config(arch), shape,
                                     microbatches=mb, device="meta")
            assert {k: tuple(v.shape) for k, v in pb.items()} == {
                k: tuple(v.shape) for k, v in jb.items()}
            want = JS.batch_specs(jb, jm, microbatched=mb > 1)
            got = S.batch_specs(pb, pm, microbatched=mb > 1)
            assert {k: tuple(v) for k, v in got.items()} == {
                k: tuple(v) for k, v in want.items()}, (shape.name, mb)
            if shape.kind == "train" and get_config(arch).family in (
                    "ssm", "hybrid"):
                over = S.data_axes(pm) + ("model",)
                got = S.batch_specs(pb, pm, mb > 1, dp_override=over)
                want = JS.batch_specs(jb, jm, mb > 1, dp_override=over)
                assert {k: tuple(v) for k, v in got.items()} == {
                    k: tuple(v) for k, v in want.items()}


@functools.lru_cache(maxsize=None)
def _jax_cache(arch):
    """The JAX decode cache of the arch's smoke config at decode_32k's
    batch and length (shapes only)."""
    cfg = jax_config(arch + "-smoke")
    model = build_model(cfg, param_dtype=jnp.bfloat16,
                        compute_dtype=jnp.bfloat16)
    return JSP.abstract_cache(model, cfg, JAX_SHAPES["decode_32k"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_are_the_references(arch):
    """The port's cache planes are the JAX cache's, name for name and shape
    for shape (the smoke config's prefill), and the rules give each plane
    the reference's spec on both production meshes and the test meshes."""
    jc = _jax_cache(arch)
    shapes = {k: tuple(v.shape) for k, v in jc.items()}
    model = LM(get_config(arch + "-smoke"), device="cpu").init(
        torch.Generator().manual_seed(0))
    fe = {}
    cfg = model.cfg
    if cfg.frontend.kind == "vision":
        fe = {"frontend_embeds": torch.zeros(
            2, cfg.frontend.num_tokens, cfg.frontend.d_frontend)}
    if cfg.family == "encdec":
        fe = {"frontend_embeds": torch.zeros(2, 6, cfg.d_model)}
    _, cache = model.prefill(torch.zeros((2, 5), dtype=torch.int32), 16,
                             **fe)
    assert set(cache) == set(shapes)
    for k, v in cache.items():
        assert v.ndim == len(shapes[k]), k
    meshes = dict(MESHES, test=((2, 2), ("data", "model")),
                  test3=((2, 2, 2), ("pod", "data", "model")))
    for shape, axes in meshes.values():
        jm = JS.make_abstract_mesh(shape, axes)
        pm = S.AbstractMesh(shape, axes)
        want = _flat(JS.cache_specs(jc, None, jm))
        got = S.cache_specs(shapes, None, pm)
        assert {k: tuple(v) for k, v in got.items()} == {
            k[0]: tuple(v) for k, v in want.items()}


# --------------------------------------------------------------- layouts
JAX_LAYOUT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    cases = json.loads(sys.argv[1])
    out = []
    devs = list(mesh.devices.flat)
    for shape, spec in cases:
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        m = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
        out.append([[[s.start or 0, (s.stop or n) - (s.start or 0)]
                     for s, n in zip(m[d], shape)] for d in devs])
    print(json.dumps(out))
""")
LAYOUT_CASES = [((8, 4, 6), [["pod", "data"], None, "model"]),
                ((4, 8), [None, ["pod", "data", "model"]]),
                ((6, 4, 2), ["model", "pod", None]),
                ((8, 8), ["data", None]),
                ((4,), [None])]


def test_to_placements_cuts_each_rank_where_jax_does():
    """Each rank's (offset, length) per dim under ``to_placements`` on a
    (pod, data, model) = (2, 2, 2) mesh equals JAX's
    ``devices_indices_map`` for the device at the same mesh coordinate
    (JAX on 8 host devices, in a subprocess)."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset as local_of
    r = subprocess.run([sys.executable, "-c", JAX_LAYOUT,
                        json.dumps(LAYOUT_CASES)], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    jax_cuts = json.loads(r.stdout.strip().splitlines()[-1])
    mesh = S.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    mesh.size = lambda i: (2, 2, 2)[i]
    for (shape, spec), want in zip(LAYOUT_CASES, jax_cuts):
        spec = S.P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        placements = S.to_placements(spec, mesh)
        for rank in range(8):
            coord = [rank // 4, rank // 2 % 2, rank % 2]
            lshape, offset = local_of(shape, (2, 2, 2), coord, placements)
            assert [[o, n] for o, n in zip(offset, lshape)] == want[rank], (
                shape, spec, coord)


def test_to_placements_refuses_an_entry_against_the_mesh_order():
    mesh = S.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    mesh.size = lambda i: 2
    with pytest.raises(ValueError, match="axis order"):
        S.to_placements(S.P(("data", "pod"), None), mesh)


# ------------------------------------------------- real DTensor numerics
def _mesh_check():
    sys.path.insert(0, str(REPO / "scripts"))
    import dtensor_mesh_check
    return dtensor_mesh_check


@pytest.mark.parametrize("kv_heads,kv_dtype", [(4, "native"), (1, "int8")])
def test_dtensor_model_computes_what_the_plain_model_computes(
        kv_heads, kv_dtype, tmp_path):
    """A 2-layer fp32 model on a 2 × 2 ``gloo`` mesh, weights placed by the
    rules (4 KV heads: heads sharded on ``model``; 1 KV head, with an int8
    cache: its projection split across a head group, so gathered before
    the head reshape): the loss (vocab-parallel cross-entropy; #9's plain
    version past ``chunk_size`` through its custom op's sharding rule),
    the prefill's last logits (vocab-parallel embedding) and a decode step
    over the sequence-sharded cache (the flash-decoding merge) equal the
    plain model's within fp32 tolerance (sums in another order). The
    cases are ``scripts/dtensor_mesh_check.py``'s, which runs them on four
    GPUs too."""
    mc = _mesh_check()
    name = {(4, "native"): "internlm2 4 KV heads",
            (1, "int8"): "internlm2 1 KV head int8"}[kv_heads, kv_dtype]
    assert mc.MODEL_CASES[[c[0] for c in mc.MODEL_CASES].index(name)][2:] \
        == ({"num_kv_heads": kv_heads}, kv_dtype)
    mc.run_cases("cpu", [("model", name)], tmp_path / "res.npz")


def test_dtensor_mla_model_computes_what_the_plain_model_computes(
        tmp_path):
    """The same on DeepSeek-V2's smoke config (MLA, MoE), its experts on
    ``model`` through the EP path: the loss and the prefill (MLA past
    ``chunk_size`` through #9's sharding rule; the latent cache's planes
    returned), then a decode step over the sequence-sharded latent cache
    (``_mla_decode_body`` on each rank's rows, the LSE merge). Capacity
    at no-drop, so the EP path and the single-device one keep the same
    tokens; MLA's head widths at (32, 32), a pair #9 is built for."""
    _mesh_check().run_cases("cpu", [("model", "deepseek-v2 MLA + EP")],
                            tmp_path / "res.npz")


def test_dtensor_model_with_a_folded_batch_computes_the_plain_model(
        tmp_path):
    """Zamba2's smoke config with the loss's batch on ``data`` ×
    ``model``, as the dry run's SSM and hybrid train cells fold the idle
    ``model`` axis into the batch: the vocab-parallel embedding gathers
    the tokens that ``model`` splits before its sum, so the loss, its
    gradients, the prefill and a decode step equal the plain model's."""
    mc = _mesh_check()
    name = "zamba2 batch on data x model"
    assert dict((c[0], c[2]) for c in mc.MODEL_CASES)[name] == {
        "batch_axes": ("data", "model")}
    mc.run_cases("cpu", [("model", name)], tmp_path / "res.npz")


def test_dtensor_train_step_computes_the_plain_train_step(tmp_path):
    """One train step of InternLM2's smoke config on a 2 × 2 ``gloo``
    mesh at 2 microbatches, its AdamW state ZeRO-1 on ``data``: each
    gradient summed once onto its moments' shard (``placed_as``), the
    norm's partial sums in one all-reduce. The loss, the gradient norm
    and both moments equal the plain step's within fp32 tolerance, and
    the parameters gathered from their ZeRO-1 masters are those
    masters."""
    mc = _mesh_check()
    assert [c[0] for c in mc.TRAIN_CASES] == ["internlm2 train step"]
    mc.run_cases("cpu", [("train", "internlm2 train step")],
                 tmp_path / "res.npz")


def test_placed_as_flattens_what_dtensor_plans_a_mesh_dim_at_a_time(
        tmp_path):
    """On eight ``gloo`` ranks, a (2, 2, 2) mesh: ``placed_as``'s one
    collective over the data axes flattened (with ``model``) gives what
    DTensor's redistribute gives, bit for bit — a ``Partial`` onto a
    shard of both data axes, to ``Replicate`` everywhere, onto one dim
    beside a cut of another, and a shard of both data axes gathered."""
    assert _mesh_check().run_flat_steps(tmp_path / "flat.npy") == 0.0


@pytest.mark.parametrize("path", ["_moe_ep", "_moe_ep_tokengather"])
def test_apply_moe_on_a_mesh_computes_the_single_device_moe(path,
                                                             tmp_path):
    """``apply_moe`` on a 2 × 2 ``gloo`` mesh, experts on ``model`` and
    their hidden dim on ``data``, at no-drop capacity: past 4096 tokens
    through ``_moe_ep``, at 64 through ``_moe_ep_tokengather``; the output
    and the aux loss equal the single-device path's within fp32
    tolerance (``_moe_ep``'s aux: the mean of each data shard's)."""
    mc = _mesh_check()
    shape = dict(mc.EP_CASES)[path]
    assert (shape[0] * shape[1] > 4096) == (path == "_moe_ep")
    mc.run_cases("cpu", [("ep", path)], tmp_path / "res.npz")
