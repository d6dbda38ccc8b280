"""Scheduler: device-idle gaps that began in repro_torch.tick.plan (the decode rows' argmax reads, the tight-pool guard, the step's rows), in % of the traced span, moving serve_tok_s."""
from perfbench import phases


def read(ctx):
    return phases.idle_share_in(ctx, "repro_torch.tick.plan")
