"""Device: ``torch.cuda.max_memory_allocated`` of the run in GiB, moving train_tok_s."""


def read(ctx):
    return ctx["memory_peak_bytes"] / 2 ** 30 if ctx.get("memory_peak_bytes") else None
