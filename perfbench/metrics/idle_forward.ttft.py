"""Model step: device-idle gaps that began in repro_torch.tick.forward (the decode ticks' host enqueue), in % of the traced span, moving ttft_p90_ms."""
from perfbench import phases


def read(ctx):
    return phases.idle_share_in(ctx, "repro_torch.tick.forward")
