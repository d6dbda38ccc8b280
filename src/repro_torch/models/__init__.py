"""Model of the port: the dense decoder with a GQA (native or int8 cache)
or MLA attention."""
from repro_torch.models.model import LM, params_from_jax

__all__ = ["LM", "params_from_jax"]
