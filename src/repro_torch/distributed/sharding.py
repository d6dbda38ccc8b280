"""Logical→physical sharding rules for every architecture family, as DTensor
placements.

The port's copy of the JAX package's ``distributed/sharding.py``. Axis
roles:

* ``pod`` + ``data``  — gradient/data parallel (batch), ZeRO-1 optimizer state
* ``model``           — TP (attention heads / ffn hidden / vocab), EP (MoE
                        experts), and KV-sequence parallelism for decode caches

SSM mixer weights are replicated on ``model``; SSM decode *states* shard
heads over ``model``.

The rules are the reference's, entry for entry: a spec (:class:`P`, one
entry per tensor dim — ``None``, an axis name, or a tuple of names, major
to minor) is computed from the JAX leaf's path names and shape. The port
keeps per-layer tensors (``blocks.3.wq``) where JAX stacks the layers into
one leaf with leading layer axes, so a port tensor's spec is its JAX
leaf's spec without those axes (:func:`param_specs` computes it on the
JAX leaf's shape, then drops them: :func:`jax_leaves` maps each port name
to its JAX path and layer axes). One exception, ZeRO-1 on a stack whose
depth the data axes divide: JAX shards the layer axis itself, which a
per-layer tensor has not, so the port's tensor takes the data axes on its
own first evenly-divisible unsharded dim instead — each rank holds the
same bytes, ``1/dp`` of every layer where JAX holds every ``dp``-th
layer whole (ROADMAP §3).

:func:`to_placements` turns a spec into one ``Shard``/``Replicate`` per
mesh dim; :func:`distribute` makes a tree of DTensors. The reference's
jax-version helpers have these counterparts: ``make_mesh`` →
:class:`torch.distributed.device_mesh.DeviceMesh`
(:mod:`repro_torch.launch.mesh`); ``make_abstract_mesh`` →
:class:`AbstractMesh` (axis names and sizes, no process group: the rules
need nothing else); ``use_mesh`` / ``get_abstract_mesh`` →
the mesh passed explicitly (a DTensor carries its own); ``shard_map`` →
``torch.distributed.tensor.experimental.local_map``.
"""
from __future__ import annotations

import math

MODEL_AXIS = "model"


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name,
    or a tuple of axis names major to minor), comparable entry by entry
    with JAX's ``PartitionSpec``, which it normalises alike: a one-name
    tuple is that name, an empty one ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_normal(e) for e in entries))

    def __repr__(self):
        return f"P{tuple(self)!r}"


def _normal(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class AbstractMesh:
    """Axis names and sizes of a mesh, without devices or a process group:
    what the spec rules read (``DeviceMesh`` serves them as well)."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _axis_size(mesh, axis) -> int:
    shape = mesh.shape
    if isinstance(shape, dict):
        return shape[axis]
    return mesh.size(_axis_names(mesh).index(axis))


def data_axes(mesh) -> tuple:
    """The gradient-parallel axes present in this mesh."""
    return tuple(a for a in ("pod", "data") if a in _axis_names(mesh))


# parameter tensors whose *last* dim is a TP output (columns sharded)
_COL_SHARDED = {"wq", "wk", "wv", "w_gate", "w_up", "w_uq", "w_dq"}
# tensors whose second-to-last dim is a TP input (rows sharded)
_ROW_SHARDED = {"wo", "w_down"}
_REPLICATED = {"router", "scale", "conv_w", "conv_b", "a_log", "dt_bias",
               "d_skip", "norm_scale", "in_proj", "out_proj", "w_kr", "a", "b"}


def _param_spec(names, ndim: int, dp=()) -> P:
    name = names[-1]
    in_experts = "experts" in names
    if name in _REPLICATED:
        return P()
    if in_experts and name in ("w_gate", "w_up", "w_down"):
        # (L?, E, d, f): experts (dim -3) over model; FSDP-shard the expert
        # hidden dim over the data axes
        spec = [None] * ndim
        spec[ndim - 3] = MODEL_AXIS
        if dp:
            f_dim = ndim - 1 if name in ("w_gate", "w_up") else ndim - 2
            spec[f_dim] = dp
        return P(*spec)
    if name == "table":
        # embedding/lm-head (V, d): shard vocab
        spec = [None] * ndim
        spec[ndim - 2] = MODEL_AXIS
        return P(*spec)
    if name in ("w_uk", "w_uv"):
        # (L?, dc, H, dn): shard heads
        spec = [None] * ndim
        spec[ndim - 2] = MODEL_AXIS
        return P(*spec)
    if name in _COL_SHARDED:
        spec = [None] * ndim
        spec[ndim - 1] = MODEL_AXIS
        return P(*spec)
    if name in _ROW_SHARDED:
        spec = [None] * ndim
        spec[ndim - 2] = MODEL_AXIS
        return P(*spec)
    if "projector" in names and ndim >= 2:
        spec = [None] * ndim
        spec[ndim - 1] = MODEL_AXIS
        return P(*spec)
    return P()


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _drop_indivisible(spec: P, shape, mesh) -> P:
    """Replace spec entries whose mesh-axis product does not divide the dim
    with None."""
    if mesh is None:
        return spec
    out = []
    for i, entry in enumerate(list(spec) + [None] * (len(shape) - len(spec))):
        axes = _axes_of(entry)
        if not axes:
            out.append(None)
            continue
        size = math.prod(_axis_size(mesh, a) for a in axes)
        out.append(entry if shape[i] % size == 0 else None)
    return P(*out)


# ------------------------------------------------------------- port names
def jax_leaves(model) -> dict:
    """Port parameter name → ``(JAX path names, layer axes)``: the path of
    the JAX package's ``LM.init`` leaf the tensor comes from (``("blocks",
    "attn", "wq")``, ``("embed", "table")``) and the sizes of the leading
    layer axes that leaf stacks (``(L,)``; ``(n_seg, seg_len)`` for the
    hybrid's ``mamba_seg``; ``()`` for a top-level leaf)."""
    from repro_torch.models import blocks as B
    from repro_torch.models.model import _jax_layers
    cfg = model.cfg
    layers = _jax_layers(cfg)
    depth: dict = {}
    for _, stack, index, _ in layers:
        idx = index if isinstance(index, tuple) else (index,)
        old = depth.get(stack, (0,) * len(idx))
        depth[stack] = tuple(max(o, i + 1) for o, i in zip(old, idx))
    out = {"embed": (("embed", "table"), ()),
           "final_ln": (("final_ln", "scale"), ())}
    if not cfg.tie_embeddings:
        out["head"] = (("head", "table"), ())
    if cfg.family == "encdec":
        out["enc_ln"] = (("enc_ln", "scale"), ())
    if cfg.frontend.kind == "vision":
        for i in range(cfg.frontend.projector_layers):
            out[f"projector.{i}"] = (("projector", f"[{i}]"), ())
    for prefix, stack, _, kind in layers:
        if kind == "ssm":
            from repro_torch.models.ssm import mixer_shapes
            paths = {n: ("mixer", n) for n in mixer_shapes(cfg)}
            paths["ln"] = ("ln", "scale")
        elif kind == "lora":
            paths = {"a": ("a",), "b": ("b",)}
        else:
            paths = {n: path for n, (_, path) in
                     {**B._matrices(cfg, kind), **B._norms(cfg, kind)}.items()}
        for n, path in paths.items():
            out[f"{prefix}.{n}"] = ((stack,) + tuple(path), depth[stack])
    return out


def _leaf_spec(names, layer_axes, shape, mesh, dp, zero1: bool) -> P:
    """The reference's spec of the JAX leaf (layer axes + ``shape``), then
    those layer axes dropped."""
    full = tuple(layer_axes) + tuple(shape)
    spec = _param_spec(names, len(full), dp)
    spec = _drop_indivisible(spec, full, mesh) if full else spec
    n = len(layer_axes)
    if zero1:
        z = _zero1(spec, full, mesh)
        if not any(_axes_of(e) for e in list(z)[:n]):
            spec = z
        else:                   # JAX shards a layer axis: see above
            own = list(spec) + [None] * (len(full) - len(spec))
            return _zero1(P(*own[n:]), tuple(shape), mesh)
    entries = list(spec) + [None] * (len(full) - len(spec))
    return P(*entries[n:])


def _zero1(base: P, shape, mesh) -> P:
    dp = data_axes(mesh)
    dp_size = math.prod(_axis_size(mesh, a) for a in dp) if dp else 1
    if dp_size <= 1 or not shape:
        return base
    spec = list(base) + [None] * (len(shape) - len(base))
    used = {a for s in spec for a in _axes_of(s)}
    if used & set(dp):
        return P(*spec)      # FSDP'd tensors are already dp-sharded
    for i, dim in enumerate(shape):
        if spec[i] is None and dim % dp_size == 0:
            spec[i] = dp
            return P(*spec)
    return P(*spec)


def param_specs(model, mesh=None) -> dict:
    """Parameter name → :class:`P` for ``model``'s parameters (the
    reference's ``param_specs`` of its JAX leaf, layer axes dropped)."""
    dp = data_axes(mesh) if mesh is not None else ()
    leaves = jax_leaves(model)
    return {n: _leaf_spec(leaves[n][0], leaves[n][1], p.shape, mesh, dp,
                          False)
            for n, p in model.named_parameters()}


def zero1_specs(model, mesh) -> dict:
    """ZeRO-1: optimizer-state spec = param spec + data axes on the first
    evenly-divisible unsharded dim of the JAX leaf (falls back to the
    param spec), layer axes dropped; where that dim is a layer axis, on
    the port tensor's own first such dim."""
    dp = data_axes(mesh)
    leaves = jax_leaves(model)
    return {n: _leaf_spec(leaves[n][0], leaves[n][1], p.shape, mesh, dp,
                          True)
            for n, p in model.named_parameters()}


def batch_specs(batch_shape: dict, mesh, microbatched: bool = False,
                dp_override=None) -> dict:
    """Shard the global-batch dim of every batch leaf (name → shape or
    tensor) over dp (dim 0, or dim 1 when the pipeline delivers
    microbatched (mb, B/mb, ...) leaves). ``dp_override`` widens the batch
    axes (SSM/hybrid train cells fold the idle ``model`` axis into data
    parallelism)."""
    dp = dp_override if dp_override is not None else data_axes(mesh)

    def fn(leaf):
        shape = tuple(getattr(leaf, "shape", leaf))
        nd = len(shape)
        if not nd:
            return P()
        if microbatched:
            spec = P(None, dp, *([None] * (nd - 2)))
        else:
            spec = P(dp, *([None] * (nd - 1)))
        return _drop_indivisible(spec, shape, mesh)
    return {k: fn(v) for k, v in batch_shape.items()}


def cache_specs(cache_shape: dict, cfg, mesh) -> dict:
    """Decode-cache shardings (cache plane name → shape or tensor): batch
    over dp; KV sequence over ``model``; SSM state heads over
    ``model``."""
    dp = data_axes(mesh)
    mo = MODEL_AXIS

    def fn(name, leaf):
        shape = tuple(getattr(leaf, "shape", leaf))
        nd = len(shape)
        if name == "pos":
            spec = P(dp)
        elif name in ("k", "v", "shared_k", "shared_v", "ek", "ev"):
            # (L, B, S, K, D) — sequence-shard over model
            spec = P(None, dp, mo, None, None)
        elif name in ("k_scale", "v_scale"):
            spec = P(None, dp, mo, None)
        elif name in ("c", "kr"):
            # MLA latents (L, B, S, dc)
            spec = P(None, dp, mo, None)
        elif name in ("ssm", "seg_ssm", "tail_ssm"):
            # (..., B, H, P, N): shard heads over model
            s = [None] * nd
            s[nd - 4] = dp
            s[nd - 3] = mo
            spec = P(*s)
        elif name in ("conv", "seg_conv", "tail_conv"):
            # (..., B, d_conv-1, conv_dim)
            s = [None] * nd
            s[nd - 3] = dp
            spec = P(*s)
        else:
            spec = P()
        return _drop_indivisible(spec, shape, mesh)
    return {k: fn(k, v) for k, v in cache_shape.items()}


# ------------------------------------------------------------- placements
def to_placements(spec, mesh) -> tuple:
    """One DTensor placement per mesh dim: ``Shard(i)`` where tensor dim
    ``i``'s entry names that mesh axis, ``Replicate()`` elsewhere — and on
    an axis of size 1, which cuts nothing (the same layout; DTensor
    refuses some reshapes of a size-1 tensor dim marked sharded). A
    multi-axis entry keeps JAX's major-to-minor order, which DTensor
    takes from the mesh's dim order: the entry's axes must come in that
    order (``("pod", "data")`` on a ``(pod, data, model)`` mesh)."""
    from torch.distributed.tensor import Replicate, Shard
    names = _axis_names(mesh)
    placements = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        axes = _axes_of(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for j in idx:
            if mesh.size(j) > 1:
                placements[j] = Shard(i)
    return tuple(placements)


def distribute(tree, specs, mesh):
    """``tree`` (a tensor, or a dict of them, nested) as DTensors on
    ``mesh`` by ``specs`` (a spec, or a dict of the same structure): each
    rank keeps its own shard, cut locally from the whole tensor (no
    collective)."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return type(tree)({n: distribute(t, specs[n], mesh)
                           for n, t in tree.items()})
    return distribute_tensor(tree, mesh, to_placements(specs, mesh),
                             src_data_rank=None)


def axis_group(mesh, axes):
    """The process group over the mesh axes ``axes`` (names; one axis, or
    several flattened major to minor), as the functional collectives take
    it."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh[axes[0]]
    return mesh[axes]._flatten()


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (a parameter made of one included)."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def all_gather(t, dim: int, group):
    """The functional all-gather of ``t`` along ``dim`` over ``group``,
    differentiable (the gradient is reduce-scattered back): torch 2.13
    names it ``all_gather_single_autograd``, earlier releases
    ``all_gather_tensor_autograd``."""
    import torch.distributed._functional_collectives as funcol
    fn = getattr(funcol, "all_gather_single_autograd", None) \
        or funcol.all_gather_tensor_autograd
    return fn(t, dim, group)


def dim_shards(t, dim: int):
    """How a DTensor ``t``'s dim ``dim`` is cut: ``(placements of a tensor
    beside it that lacks that dim — sharded as ``t`` elsewhere, replicated
    on the mesh dims that cut ``dim`` —, this rank's index among the
    pieces (major to minor), the group over those mesh dims or None)``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, place = t.device_mesh, tuple(t.placements)
    cut = Shard(dim % t.ndim)
    other = tuple(Replicate() if pl == cut else pl for pl in place)
    dims = [i for i, pl in enumerate(place) if pl == cut]
    index = 0
    for i in dims:
        index = index * mesh.size(i) + mesh.get_local_rank(i)
    group = (axis_group(mesh, [mesh.mesh_dim_names[i] for i in dims])
             if dims else None)
    return other, index, group


def local_bytes(t) -> int:
    """Bytes of the shard this rank holds (a DTensor's local tensor, or the
    whole tensor)."""
    local = t.to_local() if hasattr(t, "to_local") else t
    return local.numel() * local.element_size()
