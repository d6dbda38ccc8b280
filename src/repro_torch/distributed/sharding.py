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

import collections
import math

import torch

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


def settle_residual(t, like):
    """``t`` in the residual stream's layout, on a mesh: dim 0, the batch,
    sharded on the mesh dims where ``like`` (the stream, or the batch's
    tokens) shards its dim 0 — the batch's axes, ``model`` too where an
    SSM or hybrid cell folds it into the batch —, every other mesh dim
    replicated; and under autograd its gradient put in the same layout.

    On a branch's output (``wo``, ``w_down``, ``out_proj``, a shared
    expert, the encoder's cross-attention), the ``Partial`` a row-parallel
    product leaves on ``model`` is reduced there (an all-reduce; a
    reduce-scatter onto the batch where the batch is sharded on
    ``model``), where the reference's GSPMD and Megatron reduce. On a
    branch's normed input, the forward has nothing to move and the
    ``Partial`` gradient the column-parallel products give back is
    all-reduced before the norm's backward. Neither is left to DTensor's
    propagation, whose choice differs between torch versions (ROADMAP
    §3). A plain tensor comes back as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    batch = Shard(0)
    like = like.placements if is_dtensor(like) else ()
    target = tuple(batch if i < len(like) and like[i] == batch
                   else Replicate() for i in range(t.device_mesh.ndim))
    if torch.is_grad_enabled() and t.requires_grad:
        return _Settle.apply(t, target)
    return _placed(t, target)


def folded_weight(w, h):
    """A ``model``-sharded weight ``w`` as a product with the hidden state
    ``h`` takes it: gathered on each mesh dim that shards both ``w`` and
    ``h``'s batch (an SSM or hybrid train cell folds ``model`` into the
    batch), so each rank multiplies its own rows by the whole weight, as
    the reference's GSPMD gathers the LM head's table and Zamba2's shared
    block there; as it is anywhere else. Under autograd its gradient is
    reduce-scattered back onto ``w``'s shard on those mesh dims and kept
    ``Partial`` over the batch on the others: the tied embedding's
    gradient and each shared-block call site's meet it in that layout and
    add without a collective, and the train step sums the total once."""
    if not (is_dtensor(w) and is_dtensor(h)):
        return w
    from torch.distributed.tensor import Replicate, Shard
    dims = tuple(i for i, (pl, hp) in enumerate(zip(w.placements,
                                                     h.placements))
                 if isinstance(pl, Shard) and hp == Shard(0))
    if not dims:
        return w
    target = tuple(Replicate() if i in dims else pl
                   for i, pl in enumerate(w.placements))
    if torch.is_grad_enabled() and w.requires_grad:
        return _Gather.apply(w, target, dims)
    return _placed(w, target)


def hold_layout(t):
    """``t`` as it is, and under autograd its gradient put in ``t``'s
    layout on a mesh: where DTensor would hand back a gradient sharded in
    a way a following view cannot take (heads that a ``model`` axis
    does not divide, split in the backward of their flattening). A plain
    tensor comes back as it is."""
    if is_dtensor(t) and torch.is_grad_enabled() and t.requires_grad:
        return _Settle.apply(t, tuple(t.placements))
    return t


def replicated(t):
    """DTensor ``t`` whole on every rank (:func:`placed_as`: a ``Partial``
    sum over every mesh dim is one all-reduce); anything else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return placed_as(t, (Replicate(),) * t.device_mesh.ndim)


def placed_as(t, like):
    """DTensor ``t`` in the placements of ``like`` (a DTensor, or the
    placements themselves), anything else as it is.
    Where the change spans several mesh dims — ``Partial`` summed to
    ``Replicate`` or onto one tensor dim's shard (a gradient onto its
    ZeRO-1 shard), one tensor dim's shard gathered (a parameter from its
    ZeRO-1 master) — each kind is one collective over its mesh dims
    flattened (the data axes, with ``model``), as the reference's GSPMD
    issues one over its replica group (its multipod train step sums each
    gradient and gathers each parameter over ``pod`` × ``data``, 32
    ranks, in one collective), where DTensor plans one a mesh dim, in an
    order that differs from one torch release to the next. Any other
    change is DTensor's redistribute."""
    if not is_dtensor(t) or not (is_dtensor(like)
                                 or isinstance(like, tuple)):
        return t
    dst = tuple(like.placements) if is_dtensor(like) else like
    out = _flat_step(t, dst)
    return _placed(t, dst) if out is None else out


def _flat_step(t, dst):
    """:func:`placed_as`'s collectives, in a fixed order — the sums onto
    a shard, then the sums to ``Replicate``, then the gathers, each one
    collective over its mesh dims flattened — or None where the change
    is within one mesh dim (DTensor's one collective) or is not of these
    kinds."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, src = t.device_mesh, tuple(t.placements)
    # the sums onto a shard first: a sum to Replicate then adds shards
    steps = {"scatter": [], "reduce": [], "gather": []}
    for i, (a, b) in enumerate(zip(src, dst)):
        summed = a.is_partial() and a.reduce_op == "sum"
        if a == b or (a == Replicate() and isinstance(b, Shard)):
            continue             # a replicated dim cut moves nothing
        if summed and b == Replicate():
            steps["reduce"].append(i)
        elif summed and isinstance(b, Shard):
            steps["scatter"].append(i)
        elif isinstance(a, Shard) and b == Replicate():
            steps["gather"].append(i)
        else:
            return None
    if sum(map(len, steps.values())) < 2:
        return None
    flat = (data_axes(mesh), data_axes(mesh) + (MODEL_AXIS,))
    cuts = {"scatter": {dst[i] for i in steps["scatter"]},
            "gather": {src[i] for i in steps["gather"]}}
    for kind, dims in steps.items():
        names = tuple(mesh.mesh_dim_names[i] for i in dims)
        if len(names) > 1 and names not in flat:
            return None
        if kind != "reduce" and dims and (len(cuts[kind]) != 1 or any(
                cut in (src[i], dst[i]) for cut in cuts[kind]
                for i in range(len(src)) if i not in dims)):
            return None          # nested with another mesh dim's shard
    local = t.to_local()
    # torch 2.13's names of the single-tensor collectives; earlier
    # releases', the same ones
    rs = getattr(funcol, "reduce_scatter_single", None) \
        or funcol.reduce_scatter_tensor
    ag = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    for kind, dims in steps.items():
        if not dims:
            continue
        group = axis_group(mesh, [mesh.mesh_dim_names[i] for i in dims])
        if kind == "reduce":
            local = funcol.all_reduce(local, "sum", group)
        elif kind == "scatter":
            k = dst[dims[0]].dim
            if local.shape[k] % math.prod(mesh.size(i) for i in dims):
                return None
            local = rs(local, "sum", k, group)
        else:
            local = ag(local, src[dims[0]].dim, group)
        local = _waited(local)
    moved = {i for dims in steps.values() for i in dims}
    mid = tuple(dst[i] if i in moved else pl for i, pl in enumerate(src))
    return _placed(DTensor.from_local(local, mesh, mid, run_check=False,
                                      shape=t.shape, stride=t.stride()),
                   dst)


def _placed(t, target):
    if not is_dtensor(t) or tuple(t.placements) == target:
        return t
    return t.redistribute(t.device_mesh, target)


class _Gather(torch.autograd.Function):
    """:func:`folded_weight` under autograd."""

    @staticmethod
    def forward(ctx, w, target, dims):
        ctx.place, ctx.dims = tuple(w.placements), dims
        return _placed(w, target)

    @staticmethod
    def backward(ctx, grad):
        back = tuple(pl if pl.is_partial() and i not in ctx.dims
                     else ctx.place[i]
                     for i, pl in enumerate(grad.placements))
        return _placed(grad, back), None, None


class _Settle(torch.autograd.Function):
    """:func:`settle_residual` under autograd: the forward and the backward
    each put their tensor in the stream's layout."""

    @staticmethod
    def forward(ctx, t, target):
        ctx.target = target
        out = _placed(t, target)
        return t.view_as(t) if out is t else out

    @staticmethod
    def backward(ctx, grad):
        return _placed(grad, ctx.target), None


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


# ``local_map`` inputs that arrived Partial, by call site: the residual
# stream is settled after every row-parallel product (settle_residual), so
# in the model's runs this stays empty (the dry run records its total)
partial_guard = collections.Counter()


def local_placements(placements, where: str) -> tuple:
    """``placements`` as a ``local_map`` input's: a ``Partial`` (which
    ``local_map`` cannot redistribute to) becomes ``Replicate`` and is
    counted in :data:`partial_guard` under ``where``."""
    from torch.distributed.tensor import Replicate
    out = tuple(Replicate() if pl.is_partial() else pl for pl in placements)
    if out != tuple(placements):
        partial_guard[where] += 1
    return out


def resolve_partial(t, dim: int, where: str):
    """DTensor ``t`` with every ``Partial`` placement reduced before it
    enters a ``local_map``: reduce-scattered onto tensor dim ``dim`` where
    that dim divides evenly among the mesh dims then cutting it, else
    all-reduced; counted in :data:`partial_guard` under ``where``. Anything
    else comes back as it is."""
    if not is_dtensor(t) or not any(pl.is_partial() for pl in t.placements):
        return t
    from torch.distributed.tensor import Replicate, Shard
    mesh, cut = t.device_mesh, Shard(dim % t.ndim)
    target = list(t.placements)
    for i, pl in enumerate(target):
        if pl.is_partial():
            n = mesh.size(i) * math.prod(
                mesh.size(j) for j, q in enumerate(target) if q == cut)
            target[i] = cut if t.shape[cut.dim] % n == 0 else Replicate()
    partial_guard[where] += 1
    return t.redistribute(mesh, target)


def all_reduce_sum(t, group, grad_group=None):
    """The functional all-reduce (sum) of ``t`` over ``group``, inside a
    ``local_map`` body, with a gradient of its own: every rank of
    ``group`` holds the sum as one value, whose gradient each rank
    already has whole, so the backward passes it through — or, where the
    ranks of ``grad_group`` each keep another slice of the sum (a rank's
    own tokens), all-reduces it over ``grad_group``. Torch 2.13 registers
    for the functional all-reduce a backward that sums over ``group``
    (``group``'s size times the gradient of a replicated sum); earlier
    releases register none."""
    return _AllReduce.apply(t, group, grad_group)


def _waited(t):
    """A functional collective's result, waited for."""
    import torch.distributed._functional_collectives as funcol
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _all_reduce(t, group):
    import torch.distributed._functional_collectives as funcol
    return _waited(funcol.all_reduce(t.contiguous(), "sum", group))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, grad_group):
        ctx.grad_group = grad_group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        if ctx.grad_group is not None:
            grad = _all_reduce(grad, ctx.grad_group)
        return grad, None, None


def dim_shards(t, dim: int):
    """How a DTensor ``t``'s dim ``dim`` is cut: ``(placements of a tensor
    beside it that lacks that dim — sharded as ``t`` elsewhere, replicated
    on the mesh dims that cut ``dim`` and on any where ``t`` is Partial
    (:func:`local_placements`) —, this rank's index among the pieces
    (major to minor), the group over those mesh dims or None)``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, place = t.device_mesh, tuple(t.placements)
    cut = Shard(dim % t.ndim)
    other = local_placements(
        tuple(Replicate() if pl == cut else pl for pl in place),
        "dim_shards")
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
