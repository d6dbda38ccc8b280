"""Model of the port: the dense GQA decoder."""
from repro_torch.models.model import LM, params_from_jax

__all__ = ["LM", "params_from_jax"]
