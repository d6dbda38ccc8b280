"""Engine tick: host synchronisations (cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize) inside repro_torch.tick, a tick, moving serve_tok_s."""
from perfbench import phases


def read(ctx):
    return phases.syncs_per_tick(ctx)
