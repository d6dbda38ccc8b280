"""Scheduler: device-idle gaps that began in repro_torch.tick.admit (admission (prefill_one, the pool scatter) and the retirement before the step), in % of the traced span, moving serve_tok_s."""
from perfbench import phases


def read(ctx):
    return phases.idle_share_in(ctx, "repro_torch.tick.admit")
