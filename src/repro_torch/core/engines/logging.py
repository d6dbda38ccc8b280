"""The logging design (paper Fig. 2) as a registered engine."""
from __future__ import annotations

from repro_torch.core.clock import SimClock
from repro_torch.core.disk import Disk
from repro_torch.core.engines.base import (CacheEngine, EngineSpec,
                                           register_engine)
from repro_torch.core.nvlog import NVLog


@register_engine("nvlog")
class LogEngine(NVLog, CacheEngine):
    """Logging: sequential NVMM WAL + DRAM page cache + drainer (NVLog)."""

    @classmethod
    def from_spec(cls, spec: EngineSpec, disk: Disk,
                  clock: SimClock) -> "LogEngine":
        return cls(spec.nvmm_bytes, disk, clock,
                   dram_cache_bytes=spec.dram_cache_bytes,
                   drain_batch=spec.drain_batch,
                   log_shards=max(spec.shards, spec.drain_shards))

    def flush_all(self) -> None:
        self.drain_all()
