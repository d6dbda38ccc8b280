"""Device: share of the traced span with no device activity, in %, moving serve_tok_s."""
from perfbench import readers


def read(ctx):
    return readers.idle_share(ctx)
