"""Kernel #9 (flash attention) in prefill: the traced calls' least time over the device time of its kernels, in %, moving ttft_p90_ms."""
from perfbench import readers


def read(ctx):
    return readers.flash_roofline(ctx)
