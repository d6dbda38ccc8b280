"""Paged attention over the device KV pool (block-table indirection):
dense, int8 and MLA-latent pools, one layer or every layer at once."""
from repro_torch.kernels.paged_attention.ops import (
    mla_paged_attention, mla_paged_attention_layers_ragged,
    mla_paged_attention_ragged, paged_attention, paged_attention_layers,
    paged_attention_layers_ragged, paged_attention_layers_ragged_q8,
    paged_attention_q8, paged_attention_ragged, paged_attention_ragged_q8)

__all__ = ["mla_paged_attention", "mla_paged_attention_layers_ragged",
           "mla_paged_attention_ragged", "paged_attention",
           "paged_attention_layers", "paged_attention_layers_ragged",
           "paged_attention_layers_ragged_q8", "paged_attention_q8",
           "paged_attention_ragged", "paged_attention_ragged_q8"]
