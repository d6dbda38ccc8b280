"""Serving tier of the port: continuous batching over the pooled KV
engine, with the prefix cache, speculative decode, fault injection and the
token journal."""
from repro_torch.serving.engine import Request, ServeConfig, ServingEngine
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.speculative import DraftProposer, NGramProposer

__all__ = ["Request", "ServeConfig", "ServingEngine", "Scheduler",
           "DraftProposer", "NGramProposer"]
