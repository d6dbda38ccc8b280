"""POSIX-like shared-library surface over pluggable cache engines (paper §II).

``NVCacheFS`` provides open/pread/pwrite/preadv/pwritev/fsync/close over one
:class:`repro_torch.core.engines.CacheEngine`, constructed by name (or from
an :class:`~repro_torch.core.engines.EngineSpec`) through the engine
registry — the facade itself contains no engine-specific dispatch. Registered designs
(``python -m repro_torch.core.engines --list``):

* ``nvpages``      — the paging design (engines/paging.py)
* ``nvlog``        — the logging design (engines/logging.py)
* ``psync``        — the paper's FIO reference: plain LPC, **no** persistence
* ``psync_fsync``  — psync + fsync after every pwrite (the >1 h config)
* ``nvhybrid``     — small writes to a log, large/hot pages to a page pool

A flag in NVMM is set to 1 while loaded and 0 on clean unload; re-opening
after unload re-arms it. If a crashed image is re-opened with flag==1,
``recover()`` flushes every pending modification to disk before serving IO
(paper §II). :mod:`repro_torch.core.engines.base` holds the engine protocol;
a new design registers with ``@register_engine``.

The port's ``EngineSpec`` defaults to ``engine="paged"``, a KV engine,
so a spec handed to this facade names its FS engine; the constructor's
own default stays the reference's ``"nvlog"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

from repro_torch.core.clock import SimClock
from repro_torch.core.disk import Disk
from repro_torch.core.engines import ENGINES, EngineSpec, create_engine

__all__ = ["NVCacheFS", "ENGINES", "EngineSpec"]

# one open file occupies a 2^36-byte offset namespace inside the cache
_FILE_SPAN_BITS = 36

# detects explicitly-passed kwargs (even ones equal to their default)
_UNSET = object()


@dataclass
class _OpenFile:
    fd: int
    path: str
    base: int          # byte offset namespace start


class NVCacheFS:
    def __init__(self, engine: Union[str, EngineSpec] = "nvlog", *,
                 nvmm_bytes=_UNSET, dram_cache_bytes=_UNSET,
                 lpc_capacity_pages=_UNSET, o_direct=_UNSET, shards=_UNSET,
                 drain_batch=_UNSET, clock: Optional[SimClock] = None):
        passed = {k: v for k, v in dict(
            nvmm_bytes=nvmm_bytes, dram_cache_bytes=dram_cache_bytes,
            lpc_capacity_pages=lpc_capacity_pages, o_direct=o_direct,
            shards=shards, drain_batch=drain_batch).items()
            if v is not _UNSET}
        if isinstance(engine, EngineSpec):
            if passed:
                raise TypeError(
                    f"pass engine parameters inside the EngineSpec, not as "
                    f"keyword arguments (got both a spec and "
                    f"{sorted(passed)})")
            spec = engine
        else:
            spec = EngineSpec(engine=engine, **passed)
        self.spec = spec
        self.engine = spec.engine
        self.clock = clock or SimClock()
        self.disk = Disk(self.clock, spec.lpc_capacity_pages)
        self.cache = create_engine(spec, self.disk, self.clock)
        # persistent NVMM mount flag (paper: 1 while loaded, 0 after unload)
        self.nvmm_flag = 1 if self.cache.uses_nvmm else 0
        self._files: dict[int, _OpenFile] = {}
        self._paths: dict[str, int] = {}
        self._next_fd = 3
        self._next_slot = 0
        self.crashed = False

    # ----------------------------------------------------------------- files
    def open(self, path: str) -> int:
        assert not self.crashed, "fs crashed; call recover()"
        if path in self._paths:
            slot = self._paths[path]
        else:
            slot = self._next_slot
            self._next_slot += 1
            self._paths[path] = slot
        fd = self._next_fd
        self._next_fd += 1
        self._files[fd] = _OpenFile(fd, path, slot << _FILE_SPAN_BITS)
        self._rearm()
        return fd

    def _rearm(self) -> None:
        """Re-set the NVMM mount flag after a clean unload. Runs on open()
        and on every write path: fds stay valid across unload(), so the
        first write to an unloaded image must re-mark it dirty or a later
        crash would skip recovery and lose the write."""
        if self.cache.uses_nvmm:
            self.nvmm_flag = 1

    def _abs(self, fd: int, offset: int, length: int = 0) -> int:
        """Translate a file-relative offset; the WHOLE range must fit the
        file's 2^36-byte span (an IO ending past it would silently spill
        into the next file's address space)."""
        f = self._files[fd]
        assert 0 <= offset and offset + length <= (1 << _FILE_SPAN_BITS), \
            "IO range out of file span"
        return f.base + offset

    # -------------------------------------------------------------------- IO
    def pwrite(self, fd: int, data: bytes, offset: int) -> int:
        assert not self.crashed, "fs crashed; call recover()"
        self._rearm()
        return self.cache.pwrite(self._abs(fd, offset, len(data)), data)

    def pread(self, fd: int, n: int, offset: int) -> bytes:
        assert not self.crashed
        return self.cache.pread(self._abs(fd, offset, n), n)

    def pwritev(self, fd: int,
                iovecs: Sequence[tuple[int, bytes]]) -> int:
        """Vectorized write: ``[(offset, data), ...]`` → total bytes.
        Same tuple order as the engine-level ``CacheEngine.pwritev``."""
        assert not self.crashed
        self._rearm()
        return self.cache.pwritev(
            [(self._abs(fd, off, len(data)), data) for off, data in iovecs])

    def preadv(self, fd: int,
               iovecs: Sequence[tuple[int, int]]) -> list[bytes]:
        """Vectorized read: ``[(offset, n), ...]`` → list of blobs.
        Same tuple order as the engine-level ``CacheEngine.preadv``."""
        assert not self.crashed
        return self.cache.preadv(
            [(self._abs(fd, off, n), n) for off, n in iovecs])

    def fsync(self, fd: int) -> None:
        """Per-file durability (POSIX fsync syncs one file, not the whole
        cache): only the fd's 2^36-byte span is flushed."""
        assert not self.crashed
        f = self._files[fd]
        self.cache.fsync_range(f.base, 1 << _FILE_SPAN_BITS)

    def close(self, fd: int) -> None:
        """Drop the descriptor; the last close of a path flushes that
        path's dirty state (close-to-open consistency: closed files survive
        a crash even on the psync baseline, without making other files'
        un-synced data durable as a side effect)."""
        f = self._files.pop(fd, None)
        if f is None or self.crashed:
            return
        if not any(g.path == f.path for g in self._files.values()):
            self.cache.fsync_range(f.base, 1 << _FILE_SPAN_BITS)

    def unload(self) -> None:
        """Clean shutdown: drain/flush everything, clear the NVMM flag."""
        self.cache.flush_all()
        self.nvmm_flag = 0

    # -------------------------------------------------------- crash / recovery
    def crash(self) -> None:
        """Simulated power loss. Volatile state is dropped; NVMM + SSD
        survive. The NVMM flag stays as-is → recovery required if 1."""
        self.crashed = True
        self.cache.crash()

    def recover(self) -> float:
        """Run the paper's recovery procedure; returns simulated seconds.

        flag==1 (crashed while loaded) → full recovery: replay/flush every
        pending modification. flag==0 (clean image) → nothing pending, but
        the volatile indices still died with the power, so the engine
        remounts (metadata scan only)."""
        t0 = self.clock.now
        if self.nvmm_flag == 1:
            self.cache.recover()
        else:
            self.cache.remount()
        self.nvmm_flag = 1 if self.cache.uses_nvmm else 0
        self.crashed = False
        return self.clock.now - t0

    # ------------------------------------------------------------------ stats
    @property
    def simulated_time(self) -> float:
        return self.clock.now

    def stats(self) -> dict:
        s = {"engine": self.engine, "sim_time_s": self.clock.now,
             "tallies": dict(self.clock.tallies),
             "nvmm_capacity_bytes": self.cache.nvmm_capacity_bytes(),
             "nvmm_used_bytes": self.cache.nvmm_used_bytes()}
        s.update(self.cache.stats)
        return s
