"""Checkpoint manager: a mapping of tensors ↔ byte blobs over the core
backends.

The port's copy of the JAX package's ``CheckpointManager``. The design
switch (``design="paged" | "log"``, or any registered FS engine name such
as ``"nvhybrid"``) selects the persistence tier; the tier is built from
one :class:`~repro_torch.core.engines.EngineSpec` through the FS engine
registry. Restore after a crash runs the paper's recovery procedure first
(flag-checked replay/flush), then reads the manifest — giving bit-exact
resume.

For the logging design, ``save`` takes ``changed`` names (e.g. only the
leaves a delta step touched); unchanged state rides on the last snapshot
+ log replay.

The tree is a mapping of tensors (a ``state_dict``; mappings may nest).
Its leaves are named ``leaf0``, ``leaf1``, ... in the mapping's own
iteration order, depth first — where the reference's pytree flatten sorts
dict keys, so the two name the leaves alike only for a tree whose keys
are inserted in sorted order.
Each leaf is stored as its raw bytes (bf16 included) with its shape and
its torch dtype name. The file-system engines are host code, as in the
reference: ``save`` copies each leaf to the host once (one D2H for a card
tensor) and ``restore`` copies each one to ``like``'s device once (one
H2D for a card ``like``).
"""
from __future__ import annotations

import json
import warnings
from collections.abc import Mapping
from typing import Any, Optional

import torch

from repro_torch.core.api import NVCacheFS
from repro_torch.core.ckpt_backend import (LogCheckpointBackend,
                                           PagedCheckpointBackend)
from repro_torch.core.engines import EngineSpec, get_engine

Tree = Any

# the paper's two design names map onto engines; any registered engine name
# (e.g. "nvhybrid") is also accepted directly
_DESIGN_ENGINES = {"paged": "nvpages", "log": "nvlog"}


def _leaves(tree: Tree) -> list[torch.Tensor]:
    """The tensors of ``tree``, depth first in iteration order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _leaves(v)]
    raise TypeError(f"a checkpoint tree is a mapping of tensors; got "
                    f"{type(tree).__name__}")


def _rebuild(like: Tree, it) -> Tree:
    """``like``'s structure with its leaves taken from ``it`` in order."""
    if isinstance(like, torch.Tensor):
        return next(it)
    return type(like)((k, _rebuild(v, it)) for k, v in like.items())


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of one leaf, copied to the host once."""
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
    return raw.cpu().numpy().tobytes()


def _from_bytes(blob: bytes, dtype: torch.dtype, shape,
                device: torch.device) -> torch.Tensor:
    """One leaf from its raw bytes, copied once onto ``device`` (a copy on
    the CPU too: the tensor never aliases the immutable blob)."""
    if not blob:
        return torch.empty(shape, dtype=dtype, device=device)
    with warnings.catch_warnings():     # read-only buffer: copied below
        warnings.simplefilter("ignore", UserWarning)
        raw = torch.frombuffer(blob, dtype=torch.uint8)
    return raw.view(dtype).reshape(shape).to(device, copy=True)


def _tree_meta(leaves: list[torch.Tensor]) -> dict:
    return {f"leaf{i}": {"shape": list(t.shape),
                         "dtype": _dtype_name(t.dtype)}
            for i, t in enumerate(leaves)}


class CheckpointManager:
    _UNSET = object()

    def __init__(self, design=_UNSET, *,
                 nvmm_bytes: Optional[int] = None,
                 snapshot_every: int = 8, fs: Optional[NVCacheFS] = None,
                 spec: Optional[EngineSpec] = None):
        # the backend follows ``design`` (or the engine name passed as
        # design) OR an explicit ``spec`` — mixing the two is ambiguous;
        # an explicit ``fs`` only supplies the filesystem, never the
        # backend choice
        if fs is not None and (spec is not None or nvmm_bytes is not None):
            raise TypeError("an explicit fs already fixes the engine and "
                            "its sizing; pass only design/snapshot_every "
                            "alongside it")
        if spec is not None:
            if design is not self._UNSET:
                raise TypeError("pass either design or spec, not both")
            if nvmm_bytes is not None:
                raise TypeError("pass nvmm_bytes inside the EngineSpec, "
                                "not alongside it")
            engine = spec.engine
        else:
            design = "log" if design is self._UNSET else design
            engine = _DESIGN_ENGINES.get(design, design)
        get_engine(engine)      # typo'd design/engine fails loudly here
        if fs is None:
            if spec is None:
                spec = EngineSpec(engine=engine,
                                  nvmm_bytes=(1 << 30 if nvmm_bytes is None
                                              else nvmm_bytes))
            fs = NVCacheFS(spec)
        self.fs = fs
        # incremental (delta) saves ride on the logging engine; every other
        # engine persists full snapshots
        self.design = "log" if engine == "nvlog" else "paged"
        if self.design == "log":
            self.backend = LogCheckpointBackend(
                self.fs, snapshot_every=snapshot_every)
        else:
            self.backend = PagedCheckpointBackend(self.fs)
        self._meta_fd = self.fs.open("/ckpt/meta")

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Tree,
             changed: Optional[set] = None) -> float:
        """Persist a tree of tensors; returns simulated seconds.
        ``changed`` narrows a log-design save to the leaves whose names
        (``leaf{i}``) changed."""
        leaves = _leaves(tree)
        meta = json.dumps({"step": step,
                           "meta": _tree_meta(leaves)}).encode()
        state = {f"leaf{i}": _to_bytes(t) for i, t in enumerate(leaves)}
        if self.design == "log":
            t = self.backend.save(step, state, changed=changed)
        else:
            t = self.backend.save(step, state)
        self.fs.pwrite(self._meta_fd, len(meta).to_bytes(8, "little") + meta,
                       0)
        self.fs.fsync(self._meta_fd)
        return t

    # --------------------------------------------------------------- restore
    def restore(self, like: Tree) -> tuple[int, Tree]:
        """Rebuild a tree shaped like ``like``: the saved tensors, each on
        the device of ``like``'s leaf in its place. Raises ``ValueError``
        when the saved leaves' count, shapes or dtypes are not ``like``'s."""
        if self.fs.crashed:
            self.fs.recover()
        n = int.from_bytes(self.fs.pread(self._meta_fd, 8, 0), "little")
        if n == 0:
            raise FileNotFoundError("no checkpoint has been saved yet")
        meta = json.loads(self.fs.pread(self._meta_fd, n, 8))["meta"]
        step, state = self.backend.restore()
        leaves = _leaves(like)
        if len(leaves) != len(meta):
            raise ValueError(f"the checkpoint holds {len(meta)} leaves, "
                             f"like has {len(leaves)}")
        out = []
        for i, t in enumerate(leaves):
            key = f"leaf{i}"
            m = meta[key]
            if m["shape"] != list(t.shape) or \
                    m["dtype"] != _dtype_name(t.dtype):
                raise ValueError(
                    f"{key}: saved {m['dtype']}{m['shape']}, like has "
                    f"{_dtype_name(t.dtype)}{list(t.shape)}")
            out.append(_from_bytes(state[key], t.dtype, m["shape"],
                                   t.device))
        return step, _rebuild(like, iter(out))

    def crash(self) -> None:
        self.fs.crash()
