"""The one config object every KV-engine construction site uses.

The port's copy of the JAX package's ``EngineSpec``, cut to the fields the
port's KV engines (``paged``, ``log``, ``kvhybrid``) and serving tier read.
The file-system engines' knobs of the reference are not carried: no
engine here reads them, so no field is ever silently ignored.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EngineSpec:
    """Everything needed to build a KV cache engine."""
    engine: str = "paged"
    # log/kvhybrid drain batching: the per-entry drain service amortizes
    # one host-link write latency over this many log entries
    drain_batch: int = 64
    # kvhybrid routing: appends smaller than the threshold go to the log
    # (the *initial* threshold the online policy adapts)
    hybrid_threshold: int = 2048
    # per-shard drainer parallelism: independent FIFO drain servers for the
    # log/kvhybrid KV engines
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
