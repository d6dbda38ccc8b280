"""Log patch: replay KV log records onto page-shaped buffers in log order
(the logging design's drain path)."""
from repro_torch.kernels.log_patch.ops import log_patch

__all__ = ["log_patch"]
