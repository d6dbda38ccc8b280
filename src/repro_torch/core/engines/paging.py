"""The paging design (paper Fig. 1) as a registered engine."""
from __future__ import annotations

from repro_torch.core.clock import SimClock
from repro_torch.core.disk import Disk
from repro_torch.core.engines.base import (CacheEngine, EngineSpec,
                                           register_engine)
from repro_torch.core.nvpages import NVPages


@register_engine("nvpages")
class PagedEngine(NVPages, CacheEngine):
    """Paging: 4 KiB NVMM frames, redo log, LRU eviction (NVPages)."""

    @classmethod
    def from_spec(cls, spec: EngineSpec, disk: Disk,
                  clock: SimClock) -> "PagedEngine":
        return cls(spec.nvmm_bytes, disk, clock, o_direct=spec.o_direct,
                   shards=spec.shards)
