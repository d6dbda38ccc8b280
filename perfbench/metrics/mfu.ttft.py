"""Model step: useful model operations of the window (prompt and committed tokens, never padded slots) over the window at the bf16 peak, in %, moving ttft_p90_ms."""
from perfbench import readers


def read(ctx):
    return readers.mfu(ctx)
