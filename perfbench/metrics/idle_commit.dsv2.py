"""KV pool: device-idle gaps that began in repro_torch.tick.commit (verification, commit_step_planes, the rows' and the scheduler's bookkeeping), in % of the traced span, moving serve_tok_s."""
from perfbench import phases


def read(ctx):
    return phases.idle_share_in(ctx, "repro_torch.tick.commit")
