"""Device: share of the traced span with no device activity, in %, moving ttft_p90_ms."""
from perfbench import readers


def read(ctx):
    return readers.idle_share(ctx)
