"""Collectives, operations, bytes and live memory of one run, counted per
rank by a dispatch mode.

The counterpart of the JAX package's ``roofline/hlo.py``. The port has no
compiled HLO to parse: :class:`CostMode` watches the run itself. It sits
below DTensor (it declines every op on a DTensor, which DTensor then runs
as ops on its local shards), so everything it counts is one rank's:

* each functional collective (``torch.ops._c10d_functional``: the ones
  DTensor's redistributions and the EP bodies call) as a
  :class:`CollectiveOp` — its kind, local operand and result bytes, and
  the size of its group;
* operations, by the formulas ``torch.utils.flop_counter`` registers
  (``FlopCounterMode``'s registry; #9's custom op registers its own);
  ``FlopCounterMode`` itself counts a DTensor program at global shapes;
* "bytes accessed": the local bytes of every op's tensor inputs and
  outputs, views excluded — the pre-fusion logical traffic XLA's count
  means, an upper bound on what reaches memory;
* live bytes: each storage an op allocates counts from its op to its
  release; ``peak_bytes`` is the most live at once (the arguments that
  were alive before the run not included). Some of PyTorch's backward
  formulas fill a fresh zeros buffer in place, but out of place when a
  dispatch mode is on (``gather_backward`` tests
  ``areAnyTensorSubclassLike``): inside a backward, an accumulation into
  the zeros buffer the op just before made counts as the in-place fill
  it is in an eager run, so the peak is the eager run's. Without that
  rule a train step's peak held one more logits-sized fp32 buffer (the
  cross-entropy's gather) than the card's (``scripts/
  dryrun_memory_trace.py``).

Wire bytes keep the reference's ring factors:

    all-gather        (g-1)/g × result_bytes
    reduce-scatter    (g-1)/g × operand_bytes
    all-reduce        2 (g-1)/g × operand_bytes          (RS + AG)
    all-to-all        (g-1)/g × operand_bytes
    collective-permute  operand_bytes

DTensor derives an op's output shape by running it once more on fake
tensors of the global shapes; those runs are not the rank's work, and the
mode does not count them.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


@dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    operand_bytes: int
    group_size: int

    @property
    def wire_bytes(self) -> float:
        g = max(self.group_size, 1)
        f = (g - 1) / g
        if self.kind.startswith("all-reduce"):
            return 2 * f * self.operand_bytes
        if self.kind.startswith("all-gather"):
            return f * self.result_bytes
        if self.kind == "reduce-scatter":
            return f * self.operand_bytes
        if self.kind == "all-to-all":
            return f * self.operand_bytes
        return float(self.operand_bytes)          # collective-permute


def collective_summary(ops) -> dict:
    """Per kind ``{"count", "wire_bytes"}``, ``total_wire_bytes`` and
    ``num_ops``: the reference's keys."""
    out: dict = {}
    for op in ops:
        d = out.setdefault(op.kind, {"count": 0, "wire_bytes": 0.0})
        d["count"] += 1
        d["wire_bytes"] += op.wire_bytes
    out["total_wire_bytes"] = sum(op.wire_bytes for op in ops)
    out["num_ops"] = len(ops)
    return out


# functional collective → the reference's kind
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_out": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
          "all_reduce_coalesced": "all-reduce",
          "all_reduce_coalesced_": "all-reduce",
          "all_to_all_single": "all-to-all",
          "broadcast": "collective-permute",
          "broadcast_": "collective-permute"}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


# gather's backward: a fresh zeros buffer, then an accumulation into it
# that an eager backward runs in place
_ZEROS = torch.ops.aten.new_zeros.default
_FILL = torch.ops.aten.scatter_add.default


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


class CostMode(TorchDispatchMode):
    """Counts one rank's collectives, flops, bytes accessed and live bytes
    over the ops run inside it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.collectives: list[CollectiveOp] = []
        self.flops = 0
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}
        self._fresh = None       # the zeros buffer the last op made
        self._paused = 0
        self._restore = None

    # DTensor's shape propagation runs ops at global shapes: not counted
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        real = ShardingPropagator._propagate_tensor_meta_non_cached
        mode = self

        def propagate(prop, op_schema):
            mode._paused += 1
            try:
                return real(prop, op_schema)
            finally:
                mode._paused -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        self._restore = (ShardingPropagator, real)
        return super().__enter__()

    def __exit__(self, *exc):
        cls, real = self._restore
        cls._propagate_tensor_meta_non_cached = real
        return super().__exit__(*exc)

    def _freed(self, key, nbytes):
        if self._live.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _allocated(self, outs):
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            weakref.finalize(st, self._freed, key, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused:
            return out
        schema = func._schema
        returns_alias = any(r.alias_info is not None for r in schema.returns)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        name = func._opname if hasattr(func, "_opname") else func.__name__
        if func.namespace == "_c10d_functional" and name in _KINDS:
            self.collectives.append(CollectiveOp(
                _KINDS[name], _nbytes(outs), _nbytes(ins), _group_size(args)))
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        # a view, an in-place op, or waiting on a collective (the fake
        # tensor's wait gives a fresh tensor for the collective's own
        # buffer) allocates nothing
        if not returns_alias and name != "wait_tensor":
            self.bytes_accessed += _nbytes(ins) + _nbytes(outs)
            if func is _FILL and self._fresh is not None \
                    and id(args[0].untyped_storage()) == self._fresh[0] \
                    and torch._C._current_graph_task_id() != -1:
                self._freed(*self._fresh)    # eager fills it in place
            self._allocated(outs)
        self._fresh = None
        if func is _ZEROS and torch._C._current_graph_task_id() != -1:
            st = outs[0].untyped_storage()
            self._fresh = (id(st), st.nbytes())
        return out

    def summary(self) -> dict:
        return collective_summary(self.collectives)
