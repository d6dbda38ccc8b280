"""Paged attention over the device KV pool (block-table indirection)."""
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_attention_ragged)

__all__ = ["paged_attention", "paged_attention_ragged"]
