"""Serving tier of the port: continuous batching over the pooled KV
engine."""
from repro_torch.serving.engine import Request, ServeConfig, ServingEngine

__all__ = ["Request", "ServeConfig", "ServingEngine"]
