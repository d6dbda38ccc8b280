"""Scheduler: rows a tick over the window, decode rows and prefill-chunk rows (``SchedulerStats``), moving serve_tok_s."""


def read(ctx):
    return (ctx["decode_rows"] + ctx["prefill_chunks"]) / ctx["ticks"] if ctx.get("ticks") else None
