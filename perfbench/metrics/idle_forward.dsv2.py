"""Model step: device-idle gaps that began in repro_torch.tick.forward (the host's enqueue of every layer and the head), in % of the traced span, moving serve_tok_s."""
from perfbench import phases


def read(ctx):
    return phases.idle_share_in(ctx, "repro_torch.tick.forward")
