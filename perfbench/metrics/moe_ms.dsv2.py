"""MoE layer: device time launched inside the repro_torch.moe.* ranges (route, experts, shared) of every layer, a traced tick, in ms, moving serve_tok_s."""
from perfbench import moe_phases


def read(ctx):
    dev, recs = moe_phases.device_s_in(ctx, "repro_torch.moe."), \
        moe_phases.records(ctx)
    return 1e3 * dev / len(recs) if dev is not None else None
