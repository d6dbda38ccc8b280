"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ref.py``) and a dispatching wrapper (``ops.py``)."""
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ragged)

__all__ = ["paged_attention", "paged_attention_ragged"]
