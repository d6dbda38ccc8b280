"""nvhybrid: the combined design the paper motivates but never builds.

The paper's conclusion: logging wins small synchronous writes (1× NVMM
write, DRAM-speed reads) while paging wins large/aligned IO and absorbs
hot-page overwrites in NVMM. ``HybridEngine`` routes each page-granular
write chunk accordingly:

* chunks below ``EngineSpec.hybrid_threshold`` bytes → an NVLog journal
  (sequential NVMM append, background drain);
* full-page or ≥-threshold chunks, and any write to a page already resident
  in the page cache → an NVPages pool.

Coherence is by **page ownership**: at any moment a page's pending state
lives in exactly one component. Before the page side takes over a page, the
journal is force-drained for it (log drains before page flush — the unified
recovery ordering), and the journal's DRAM copy is invalidated. Reads are
served by whichever side owns the page (NVMM frame if resident, else the
journal's DRAM cache / LPC path).

Crash recovery runs the same ordering: replay the journal to disk first,
then rebuild the page side from NVMM frame headers and flush — ownership
makes the two record sets disjoint, so the combined engine inherits both
components' no-data-loss guarantees (tested against nvlog/nvpages oracles
in tests/test_torch_fs_engines.py).
"""
from __future__ import annotations

from repro_torch.core.clock import SimClock
from repro_torch.core.disk import Disk, PAGE_SIZE, iter_page_chunks
from repro_torch.core.engines.base import (CacheEngine, EngineSpec,
                                           register_engine)
from repro_torch.core.nvlog import NVLog
from repro_torch.core.nvpages import NVPages


@register_engine("nvhybrid")
class HybridEngine(CacheEngine):
    """Hybrid: NVLog journal for small writes, NVPages for large/hot pages."""

    # no keyword defaults: every knob comes from EngineSpec via from_spec,
    # so the single source of default values stays EngineSpec
    def __init__(self, disk: Disk, clock: SimClock, *, nvmm_bytes: int,
                 dram_cache_bytes: int, threshold: int, log_fraction: float,
                 shards: int, drain_batch: int, o_direct: bool,
                 drain_shards: int = 1):
        assert 0.0 < log_fraction < 1.0, log_fraction
        assert nvmm_bytes >= 128 << 10, "nvhybrid needs >=128 KiB of NVMM"
        assert drain_shards >= 1, drain_shards
        # split the budget, never exceed it: a 64 KiB journal floor, but
        # the page pool always keeps at least half
        log_bytes = min(max(int(nvmm_bytes * log_fraction), 64 << 10),
                        nvmm_bytes // 2)
        page_bytes = nvmm_bytes - log_bytes
        self.threshold = threshold
        # journal drainer parallelism is its own knob: WAL shards are the
        # drain shards (one independent FIFO server each, ShardedDrainer),
        # while ``shards`` keeps governing the page pool's structure
        self.log = NVLog(log_bytes, disk, clock,
                         dram_cache_bytes=dram_cache_bytes,
                         drain_batch=drain_batch,
                         log_shards=max(shards, drain_shards))
        self.pages = NVPages(page_bytes, disk, clock, o_direct=o_direct,
                             shards=shards)
        self._stats = {"routed_log": 0, "routed_pages": 0,
                       "page_takeovers": 0}

    @classmethod
    def from_spec(cls, spec: EngineSpec, disk: Disk,
                  clock: SimClock) -> "HybridEngine":
        return cls(disk, clock, nvmm_bytes=spec.nvmm_bytes,
                   dram_cache_bytes=spec.dram_cache_bytes,
                   threshold=spec.hybrid_threshold,
                   log_fraction=spec.hybrid_log_fraction,
                   shards=spec.shards, drain_batch=spec.drain_batch,
                   o_direct=spec.o_direct, drain_shards=spec.drain_shards)

    @property
    def stats(self) -> dict:
        out = dict(self._stats)
        out.update({f"log_{k}": v for k, v in self.log.stats.items()})
        out.update({f"pages_{k}": v for k, v in self.pages.stats.items()})
        return out

    # -------------------------------------------------------------------- IO
    def pwrite(self, offset: int, data: bytes) -> int:
        for pos, pno, in_page, n in iter_page_chunks(offset, len(data)):
            chunk = data[pos:pos + n]
            large = (in_page == 0 and n == PAGE_SIZE) or n >= self.threshold
            if large or self.pages.is_resident(pno):
                # page side takes (or keeps) ownership: the journal must
                # reach disk for this page first, and its DRAM copy dies
                if self.log.has_pending(pno):
                    self.log.force_drain_page(pno)
                    self._stats["page_takeovers"] += 1
                self.log.invalidate(pno)
                self.pages.pwrite(offset + pos, chunk)
                self._stats["routed_pages"] += 1
            else:
                self.log.pwrite(offset + pos, chunk)
                self._stats["routed_log"] += 1
        return len(data)

    def pread(self, offset: int, n: int) -> bytes:
        out = bytearray()
        for pos, pno, _, take in iter_page_chunks(offset, n):
            # is_resident repeats the index lookup pages.pread will do;
            # that costs host wall-clock only — no simulated time is
            # charged for index walks, so the model stays exact
            if self.pages.is_resident(pno):
                out += self.pages.pread(offset + pos, take)
            else:
                out += self.log.pread(offset + pos, take)
        return bytes(out)

    def fsync(self) -> None:
        """No-op: both routes are durable at pwrite return."""

    # --------------------------------------------------- lifecycle / recovery
    def flush_all(self) -> None:
        self.log.drain_all()
        self.pages.flush_all()

    def crash(self) -> None:
        self.log.crash()
        self.pages.crash()

    def remount(self) -> None:
        self.pages.remount()        # the journal's caches rebuild lazily

    def recover(self) -> None:
        # unified ordering: journal replays to disk before the page side
        # rebuilds and flushes (ownership keeps the page sets disjoint).
        # The journal skips its terminal barrier — pages.recover() ends in
        # flush_all → fsync, which persists the replayed journal pages too,
        # so the combined engine pays SSD_FSYNC_LATENCY exactly once.
        self.log.recover(barrier=False)
        self.pages.recover()

    # -------------------------------------------------- capacity accounting
    def nvmm_capacity_bytes(self) -> int:
        return (self.log.nvmm_capacity_bytes()
                + self.pages.nvmm_capacity_bytes())

    def nvmm_used_bytes(self) -> int:
        return self.log.nvmm_used_bytes() + self.pages.nvmm_used_bytes()
