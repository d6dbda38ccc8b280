"""Model step: device time of the work launched in repro_torch.train.backward (torch.autograd.grad, the remat recompute included), a traced step, in ms, moving train_tok_s."""
from perfbench import phases


def read(ctx):
    return phases.device_ms_per_step(ctx, "repro_torch.train.backward")
