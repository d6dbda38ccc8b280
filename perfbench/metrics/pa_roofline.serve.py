"""Kernel #1 (paged attention): the traced calls' least time over the device time of its kernels, in %, moving serve_tok_s."""
from perfbench import readers


def read(ctx):
    return readers.paged_roofline(ctx)
