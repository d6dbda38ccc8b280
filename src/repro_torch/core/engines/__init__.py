"""KV engine protocol, config object, registry and cache descriptors."""
from repro_torch.core.engines.base import EngineSpec
from repro_torch.core.engines.kv import (KVCacheEngine, create_kv_engine,
                                         get_kv_engine, list_kv_engines,
                                         register_kv_engine)

__all__ = ["EngineSpec", "KVCacheEngine", "create_kv_engine",
           "get_kv_engine", "list_kv_engines", "register_kv_engine"]
