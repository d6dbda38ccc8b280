"""Host-side cache machinery of the port: simulated clock, LRU, the KV
engine registry and the pooled paged KV engine."""
from repro_torch.core.clock import SimClock

__all__ = ["SimClock"]
