"""Model step: real tokens over padded slots of the traced ticks' ragged steps (step_tokens / step_slots), in %, moving serve_tok_s."""
from perfbench import phases


def read(ctx):
    recs = phases.tick_records(ctx)
    slots = sum(r.step_slots for r in recs) if recs else 0
    return 100.0 * sum(r.step_tokens for r in recs) / slots if slots \
        else None
