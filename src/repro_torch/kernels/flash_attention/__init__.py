"""Flash attention, forward: causal or non-causal GQA over dense q, k, v
(the long-prompt prefill's attention)."""
from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["flash_attention"]
