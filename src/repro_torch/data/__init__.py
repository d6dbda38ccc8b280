"""Deterministic synthetic LM data pipeline (sharded, restart-stable):
the port's numpy copy of the JAX package's ``repro.data``, batch for batch
the same arrays."""
from repro_torch.data.synthetic import SyntheticLMDataset, make_batch_iterator

__all__ = ["SyntheticLMDataset", "make_batch_iterator"]
