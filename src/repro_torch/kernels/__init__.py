"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ref.py``) and a dispatching wrapper (``ops.py``)."""
from repro_torch.kernels.paged_attention import (
    mla_paged_attention, mla_paged_attention_ragged, paged_attention,
    paged_attention_q8, paged_attention_ragged, paged_attention_ragged_q8)

__all__ = ["mla_paged_attention", "mla_paged_attention_ragged",
           "paged_attention", "paged_attention_q8", "paged_attention_ragged",
           "paged_attention_ragged_q8"]
