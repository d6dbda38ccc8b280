"""KV pool: the highest ``tiered.pressure()`` after a tick of the window, in %, moving serve_tok_s."""


def read(ctx):
    return 100.0 * ctx["pressure_peak"]
