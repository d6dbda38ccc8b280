"""The one config object every KV-engine construction site uses.

The port's copy of the JAX package's ``EngineSpec``, cut to the fields the
port's ``paged`` engine reads. Each other field of the reference (the
file-system engines' knobs, the log and hybrid engines' drain and routing
knobs) comes back with the slice that ports the engine reading it, so no
field here is ever silently ignored.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EngineSpec:
    """Everything needed to build a KV cache engine."""
    engine: str = "paged"
    # device page-pool budget in bytes (sets the pool's page count)
    kv_hbm_bytes: int = 64 << 20
    # cross-request prefix cache: token capacity of the radix index over
    # shared pool pages; 0 disables sharing. Not ported yet: the serving
    # engine refuses any other value
    prefix_cache_tokens: int = 0
    # async tiering: pooled spills/faults go through a background transfer
    # pipeline instead of stalling the foreground; False keeps every
    # transfer synchronous
    async_tiering: bool = False
    # retry budget and base backoff for failed async transfer submissions;
    # past the budget the pipeline escalates to synchronous tiering
    transfer_max_retries: int = 3
    transfer_backoff_s: float = 1e-4
