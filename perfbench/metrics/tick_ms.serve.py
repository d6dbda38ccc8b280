"""Engine tick: the window over the ticks run in it, in ms, moving serve_tok_s."""


def read(ctx):
    return 1e3 * ctx["seconds"] / ctx["ticks"] if ctx.get("ticks") else None
