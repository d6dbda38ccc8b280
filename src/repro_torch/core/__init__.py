"""The paper's NVMM cache designs (paging, logging and their hybrid) as one
library behind pluggable engine registries: the file-system tier
(``NVCacheFS`` over ``nvpages``/``nvlog``/``psync``/``psync_fsync``/
``nvhybrid``), the KV-cache tier of the serving engine (``paged``/``log``/
``kvhybrid``), the simulated clock and the checkpoint backends."""
from repro_torch.core.api import NVCacheFS, ENGINES
from repro_torch.core.clock import SimClock
from repro_torch.core.disk import Disk, PAGE_SIZE
from repro_torch.core.engines import (CacheEngine, EngineSpec, KVCacheEngine,
                                      create_engine, create_kv_engine,
                                      list_kv_engines, register_engine,
                                      register_kv_engine)
from repro_torch.core.nvlog import NVLog
from repro_torch.core.nvpages import NVPages

__all__ = ["NVCacheFS", "ENGINES", "SimClock", "Disk", "PAGE_SIZE", "NVLog",
           "NVPages", "CacheEngine", "EngineSpec", "create_engine",
           "register_engine", "KVCacheEngine", "create_kv_engine",
           "list_kv_engines", "register_kv_engine"]
