"""Model of the port: the decoder with GQA (native or int8 cache) or MLA
attention and a dense or MoE FFN, the Mamba-2 state-space stack and the
Zamba2 hybrid of it with shared attention blocks, the VLM and the
encoder-decoder; ``LM.loss_fn`` trains every family."""
from repro_torch.models.model import LM, jax_leaf_ndims, params_from_jax

__all__ = ["LM", "jax_leaf_ndims", "params_from_jax"]
