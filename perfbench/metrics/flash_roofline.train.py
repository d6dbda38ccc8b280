"""Kernel #9 (flash attention) in training, forward and recomputation: the traced calls' least time over the device time of its kernels, in %, moving train_tok_s."""
from perfbench import readers


def read(ctx):
    return readers.flash_roofline(ctx)
