"""KV pool: device-idle gaps that began in repro_torch.tick.prepare (the padded arrays, prepare_step, the drift check, the uploads), in % of the traced span, moving serve_tok_s."""
from perfbench import phases


def read(ctx):
    return phases.idle_share_in(ctx, "repro_torch.tick.prepare")
