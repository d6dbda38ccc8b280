"""Model of the port: the decoder with GQA (native or int8 cache) or MLA
attention and a dense or MoE FFN, the Mamba-2 state-space stack and the
Zamba2 hybrid of it with shared attention blocks."""
from repro_torch.models.model import LM, params_from_jax

__all__ = ["LM", "params_from_jax"]
