"""Flash attention, forward: causal or non-causal GQA over dense q, k, v
(the long-prompt prefill's attention), and ``FlashAttentionFn``, the same
forward under autograd for the training path."""
from repro_torch.kernels.flash_attention.ops import (FlashAttentionFn,
                                                     flash_attention)

__all__ = ["FlashAttentionFn", "flash_attention"]
