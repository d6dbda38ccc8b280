"""What the per-layer metric readers (``metrics/<name>.py``) share.

Each reader takes the context its cell's loop left and returns a number,
or None where it finds nothing to read (then the metric is left out of
the line). A share of a roofline or of the peak is never made up: with no
device time to divide by, or no work counted, it is None.
"""
from __future__ import annotations

import numpy as np

from perfbench import counts


def idle_share(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (tr.window_s - tr.busy_s) / tr.window_s


def mfu(ctx):
    """Useful model operations over the window, as a share of the card's
    bf16 peak over the window."""
    flops = ctx.get("useful_flops", 0)
    if not flops:
        return None
    return 100.0 * flops / (ctx["seconds"] * counts.PEAK_BF16_FLOPS)


def roofline(bound_s, device_s):
    if not bound_s or not device_s:
        return None
    return 100.0 * bound_s / device_s


def paged_roofline(ctx):
    """#1: the least time of every traced paged-attention call (one a
    layer a fused step) over the device time of its kernels."""
    tr, a = ctx.get("trace"), ctx["arch"]
    if tr is None:
        return None
    bound = sum(a.L * counts.bound_s(*counts.paged_work(
        rows, ctx["page_tokens"], a.H, a.K, a.D)) for rows in
        ctx["paged_calls"])
    return roofline(bound, tr.device_s("paged_attention", exclude=("mla",)))


def flash_roofline(ctx):
    """#9: the least time of every traced flash-attention call over the
    device time of its kernels. ``flash_calls`` are ``(batch, seq)`` of
    calls that each run once a layer."""
    tr, a = ctx.get("trace"), ctx["arch"]
    if tr is None:
        return None
    bound = sum(n_layers * counts.bound_s(*counts.flash_work(
        b, s, s, a.H, a.K, a.D, a.D)) for b, s, n_layers in
        ctx["flash_calls"])
    return roofline(bound, tr.device_s("flash_attention"))


def percentile_ms(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) * 1e3 \
        if xs else None
