"""Engine config object, the FS engine protocol, and its registry.

The port's copy of the JAX package's ``engines/base.py``.

``EngineSpec`` is the one config object every construction site uses —
the ``NVCacheFS`` facade, the checkpoint manager and the serving tier.
Its ``engine`` defaults to ``"paged"``, the port's KV serving engine (the
reference's default is the file-system engine ``"nvlog"``); every other
field default is the reference's.

``CacheEngine`` is the formal contract every file-system cache design
implements: byte-granular ``pwrite``/``pread`` (plus vectorized
``pwritev``/``preadv``), durability (``fsync``, ``flush_all``), the
paper's crash protocol (``crash``/``recover``), a ``stats`` mapping, and
NVMM capacity accounting.

New designs register with ``@register_engine("name")`` and are constructed
via ``create_engine(spec, disk, clock)``; unknown names raise
``ValueError``. The FS and KV registries are separate dicts whose names do
not collide (``nvpages``/``paged``, ``nvlog``/``log``,
``nvhybrid``/``kvhybrid``); a name of the other registry is refused with a
message that names both.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.core.clock import SimClock
from repro_torch.core.disk import Disk


@dataclass(frozen=True)
class EngineSpec:
    """Everything needed to build a cache engine (paper's table of knobs).

    ``hybrid_*`` fields only matter for the nvhybrid engine (and
    ``hybrid_threshold`` for kvhybrid) but live here so one spec object can
    describe any engine of either registry.
    """
    engine: str = "paged"
    # file-system tier: NVMM budget and NVLog's DRAM page cache
    nvmm_bytes: int = 2 << 30
    dram_cache_bytes: int = 2 << 30
    # NVPages frame-pool / NVLog WAL shards (paper §IV future work)
    shards: int = 1
    # log drain batching: the per-entry drain service amortizes one write
    # latency and one fsync over this many log entries
    drain_batch: int = 64
    o_direct: bool = False
    # LPC capacity in pages (None = unbounded)
    lpc_capacity_pages: Optional[int] = None
    # nvhybrid/kvhybrid routing: writes smaller than the threshold go to the
    # log (for kvhybrid this is the *initial* threshold the online policy
    # adapts)
    hybrid_threshold: int = 2048
    # nvhybrid NVMM split: fraction given to the journal, rest to pages
    hybrid_log_fraction: float = 0.25
    # per-shard drainer parallelism: independent FIFO drain servers for the
    # log side of nvhybrid and for the log/kvhybrid KV engines
    drain_shards: int = 1
    # KV-tier HBM budget in bytes: the device page pool's size (paged,
    # pooled), the HBM working set (paged, host mode), or the total of the
    # hot windows (log, kvhybrid)
    kv_hbm_bytes: int = 64 << 20
    # log/kvhybrid: per-sequence hot window, in most recent tokens
    kv_hot_window: int = 128
    # cross-request prefix cache: token capacity of the radix index over
    # shared pool pages; 0 disables sharing (pooled path only)
    prefix_cache_tokens: int = 0
    # async tiering: pooled spills/faults go through a background transfer
    # pipeline instead of stalling the foreground; False keeps every
    # transfer synchronous
    async_tiering: bool = False
    # retry budget and base backoff for failed async transfer submissions;
    # past the budget the pipeline escalates to synchronous tiering
    transfer_max_retries: int = 3
    transfer_backoff_s: float = 1e-4


class CacheEngine(abc.ABC):
    """Abstract base for all cache engines behind :class:`NVCacheFS`."""

    #: registry key, filled in by ``@register_engine``
    engine_name: str = "?"
    #: True if the engine persists data in NVMM (drives the mount-flag
    #: protocol: psync engines have nothing to recover)
    uses_nvmm: bool = True
    #: per-engine counters; the facade merges this into its ``stats()``
    stats: dict

    @classmethod
    @abc.abstractmethod
    def from_spec(cls, spec: EngineSpec, disk: Disk,
                  clock: SimClock) -> "CacheEngine":
        """Construct the engine from one config object."""

    # -------------------------------------------------------------------- IO
    @abc.abstractmethod
    def pwrite(self, offset: int, data: bytes) -> int:
        """Write ``data`` at byte ``offset``; returns bytes written."""

    @abc.abstractmethod
    def pread(self, offset: int, n: int) -> bytes:
        """Read ``n`` bytes at byte ``offset``."""

    def pwritev(self, iovecs: Sequence[tuple[int, bytes]]) -> int:
        """Vectorized write: ``[(offset, data), ...]`` → total bytes.

        The default loops; engines may override to amortize per-call work
        (drainer advance, batching) across the whole vector.
        """
        return sum(self.pwrite(off, data) for off, data in iovecs)

    def preadv(self, iovecs: Sequence[tuple[int, int]]) -> list[bytes]:
        """Vectorized read: ``[(offset, n), ...]`` → list of byte blobs."""
        return [self.pread(off, n) for off, n in iovecs]

    @abc.abstractmethod
    def fsync(self) -> None:
        """Make all acked writes durable (no-op for the NVMM designs)."""

    def fsync_range(self, offset: int, length: int) -> None:
        """Make acked writes in ``[offset, offset+length)`` durable (the
        facade's per-file close path). Defaults to a full :meth:`fsync`;
        engines with a cheaper scoped flush override it."""
        self.fsync()

    # --------------------------------------------------- lifecycle / recovery
    @abc.abstractmethod
    def flush_all(self) -> None:
        """Clean shutdown: drain/flush every pending modification to disk."""

    @abc.abstractmethod
    def crash(self) -> None:
        """Simulated power loss: drop volatile state; NVMM + SSD survive."""

    @abc.abstractmethod
    def recover(self) -> None:
        """Paper §II recovery: flush every modification pending at crash.
        Implies :meth:`remount`."""

    def remount(self) -> None:
        """Rebuild volatile metadata from NVMM after a crash of a *clean*
        image (mount flag 0: nothing pending to replay or flush). Engines
        whose volatile state rebuilds lazily keep this a no-op."""

    # -------------------------------------------------- capacity accounting
    def nvmm_capacity_bytes(self) -> int:
        """NVMM the engine actually provisioned (frames, logs, redo) — may
        round below the requested ``spec.nvmm_bytes``; LPC-only engines
        report 0."""
        return 0

    def nvmm_used_bytes(self) -> int:
        return 0


_REGISTRY: dict[str, type[CacheEngine]] = {}


def register_engine(name: str, *, override: bool = False):
    """Class decorator: make an engine constructible by name.

    Re-registering an existing name raises unless ``override=True`` — a
    silent replacement of a built-in would corrupt every registry-driven
    construction site while all names still look correct.
    """
    def deco(cls: type[CacheEngine]) -> type[CacheEngine]:
        if not override and name in _REGISTRY:
            raise ValueError(
                f"engine {name!r} is already registered "
                f"({_REGISTRY[name].__name__}); pass override=True to "
                f"replace it")
        cls.engine_name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_engine(name: str) -> type[CacheEngine]:
    try:
        return _REGISTRY[name]
    except KeyError:
        from repro_torch.core.engines.kv import list_kv_engines
        kv = list_kv_engines()
        hint = (f"; {name!r} is in the KV engine registry "
                f"({', '.join(sorted(kv))}): build it with "
                f"create_kv_engine" if name in kv else "")
        raise ValueError(
            f"unknown cache engine {name!r}; registered engines: "
            f"{', '.join(sorted(_REGISTRY))}{hint}") from None


def create_engine(spec: EngineSpec, disk: Disk,
                  clock: SimClock) -> CacheEngine:
    """Build the engine named by ``spec.engine`` over ``disk``/``clock``."""
    return get_engine(spec.engine).from_spec(spec, disk, clock)


def list_engines() -> tuple[str, ...]:
    return tuple(_REGISTRY)
