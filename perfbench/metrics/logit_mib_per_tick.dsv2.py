"""Model step: bytes of the logits the head returned (logit_bytes), a traced tick, in MiB, moving serve_tok_s (the DeepSeek-V2 cell)."""
from perfbench import phases


def read(ctx):
    recs = phases.tick_records(ctx)
    return sum(r.logit_bytes for r in recs) / len(recs) / 2 ** 20 if recs \
        else None
