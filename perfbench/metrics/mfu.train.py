"""Model step: three forward passes' useful operations a completed step over the window at the bf16 peak, in %, moving train_tok_s."""
from perfbench import readers


def read(ctx):
    return readers.mfu(ctx)
