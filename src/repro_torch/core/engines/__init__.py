"""Pluggable cache-engine package: protocols, registries, and the designs.

Two registries share one :class:`EngineSpec` config object:

* the FS tier (``CacheEngine``: nvpages/nvlog/psync/psync_fsync/nvhybrid)
  behind the ``NVCacheFS`` facade — importing this package registers them;
* the KV-cache serving tier (``KVCacheEngine``: paged/log/kvhybrid) behind
  the serving engine — built-ins register on first ``create_kv_engine`` /
  ``list_kv_engines`` call (they live in :mod:`repro_torch.core.kvcache`).

    from repro_torch.core.engines import EngineSpec, create_engine, ENGINES
    from repro_torch.core.engines import create_kv_engine, list_kv_engines

``python -m repro_torch.core.engines --list`` prints both registries and
the engine × config-family support matrix.
"""
from repro_torch.core.engines.base import (CacheEngine, EngineSpec,
                                           create_engine, get_engine,
                                           list_engines, register_engine)
from repro_torch.core.engines.kv import (KVCacheEngine, create_kv_engine,
                                         get_kv_engine, list_kv_engines,
                                         register_kv_engine)
# importing the modules registers the engines (order = listing order)
from repro_torch.core.engines import paging     # noqa: F401  (nvpages)
from repro_torch.core.engines import logging    # noqa: F401  (nvlog)
from repro_torch.core.engines import psync      # noqa: F401  (psync, psync_fsync)
from repro_torch.core.engines import hybrid     # noqa: F401  (nvhybrid)
from repro_torch.core.engines.hybrid import HybridEngine
from repro_torch.core.engines.logging import LogEngine
from repro_torch.core.engines.paging import PagedEngine
from repro_torch.core.engines.psync import PsyncEngine, PsyncFsyncEngine

#: built-in engine names, in registration order. This is an import-time
#: snapshot for convenient parametrization; enumerators that must see
#: engines registered later (plugins) call ``list_engines()`` at use time.
ENGINES: tuple[str, ...] = list_engines()

__all__ = ["CacheEngine", "EngineSpec", "ENGINES", "create_engine",
           "get_engine", "list_engines", "register_engine", "HybridEngine",
           "LogEngine", "PagedEngine", "PsyncEngine", "PsyncFsyncEngine",
           "KVCacheEngine", "create_kv_engine", "get_kv_engine",
           "list_kv_engines", "register_kv_engine"]
