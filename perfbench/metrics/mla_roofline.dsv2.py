"""Kernel #7 (MLA paged attention over the latent pool): the traced fused steps' least time (each layer's call, perfbench/moe_counts.py) over the device time of its kernels, in %, moving serve_tok_s."""
from perfbench import moe_counts, readers


def read(ctx):
    tr, a = ctx.get("trace"), ctx["arch"]
    if tr is None:
        return None
    bound = sum(a.L * moe_counts.bound_s(*moe_counts.mla_work(
        rows, ctx["page_tokens"], a)) for rows in ctx["paged_calls"])
    return readers.roofline(bound, tr.device_s("mla_paged_attention"))
