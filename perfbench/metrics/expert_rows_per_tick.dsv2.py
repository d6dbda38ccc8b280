"""MoE layer: (token, held expert) rows the held experts computed (the program's expert_rows, summed over its layers), a traced tick, moving serve_tok_s."""
from perfbench import moe_phases


def read(ctx):
    recs = moe_phases.records(ctx)
    return sum(int(r.expert_rows) for r in recs) / len(recs) if recs \
        else None
