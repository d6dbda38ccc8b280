"""MoE layer: the held experts' least time over the traced ticks (their rows and the experts given work) over the device time launched inside repro_torch.moe.experts (dispatch, grouped products, combine), in %, moving serve_tok_s."""
from perfbench import moe_phases


def read(ctx):
    return moe_phases.expert_roofline(ctx)
