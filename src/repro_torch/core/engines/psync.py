"""The paper's FIO reference baselines as real engines (no NVMM).

``psync`` is plain pread/pwrite through the Linux page cache — no
persistence until fsync, the configuration the paper measures as "the
performance of the LPC in DRAM". ``psync_fsync`` adds an fsync after every
pwrite (the paper's >1 h configuration). Both are first-class engines
sharing the byte-granular LPC helpers in :mod:`repro_torch.core.disk`.
"""
from __future__ import annotations

from repro_torch.core.clock import SimClock
from repro_torch.core.disk import Disk, PAGE_SIZE
from repro_torch.core.engines.base import (CacheEngine, EngineSpec,
                                           register_engine)


@register_engine("psync")
class PsyncEngine(CacheEngine):
    """psync: buffered IO through the LPC; durable only at fsync."""

    uses_nvmm = False

    def __init__(self, disk: Disk, clock: SimClock):
        self.disk = disk
        self.clock = clock
        self.stats = {"lpc_writes": 0, "lpc_reads": 0, "fsyncs": 0}

    @classmethod
    def from_spec(cls, spec: EngineSpec, disk: Disk,
                  clock: SimClock) -> "PsyncEngine":
        return cls(disk, clock)

    def pwrite(self, offset: int, data: bytes) -> int:
        self.stats["lpc_writes"] += 1
        return self.disk.write_bytes(offset, data)

    def pread(self, offset: int, n: int) -> bytes:
        self.stats["lpc_reads"] += 1
        return self.disk.read_bytes(offset, n)

    def fsync(self) -> None:
        self.stats["fsyncs"] += 1
        self.disk.fsync()

    def fsync_range(self, offset: int, length: int) -> None:
        """Per-file sync: flush only the range's dirty LPC pages, leaving
        other files' un-synced data volatile (POSIX fsync is per-file)."""
        self.stats["fsyncs"] += 1
        self.disk.fsync_range(offset // PAGE_SIZE,
                              -(-(offset + length) // PAGE_SIZE))

    def flush_all(self) -> None:
        self.disk.fsync()

    def crash(self) -> None:
        self.disk.crash()

    def recover(self) -> None:
        """Nothing to replay: un-fsync'd LPC contents are simply lost."""


@register_engine("psync_fsync")
class PsyncFsyncEngine(PsyncEngine):
    """psync + fsync after every pwrite (durable, catastrophically slow)."""

    def pwrite(self, offset: int, data: bytes) -> int:
        n = super().pwrite(offset, data)
        self.fsync()
        return n
