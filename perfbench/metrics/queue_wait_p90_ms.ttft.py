"""Scheduler: 90th percentile of the wait from a request being due to its leaving the waiting queue, in ms, moving ttft_p90_ms."""
from perfbench import readers


def read(ctx):
    return readers.percentile_ms(ctx.get("queue_waits"), 90)
