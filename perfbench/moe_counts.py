"""The work of a DeepSeek-V2-style decoder and of its kernels, for the
per-layer metrics of its cell: copied into the benchmark, as
:mod:`perfbench.counts` is, so that no change to the program can move it.

* MLA decode over the paged latent pool (#7, weight-absorbed): each live
  page of a row with queries read once (latent and rope key, in the pool's
  dtype), each query's absorbed latent and rope query read once and its
  attended latent written once (fp32), ``2 (dc + dr) + 2 dc`` operations
  a (query, key) pair and head;
* the held experts' products: the weights of each expert given rows read
  once, each row's input read and its output written once (bf16),
  ``6 d f`` operations a (token, expert) row;
* useful operations of a token: the attention's projections, the
  absorbed attention (``w_uk`` into the query, ``w_uv`` out of the
  latent, the pairs), the dense layers' FFN, the router and the shared
  experts a token, the held experts a row they computed, the head a row.

``a`` is a :class:`perfbench.moe_weights.MoEArch`. Imports nothing of the
program.
"""
from __future__ import annotations

from perfbench.counts import bound_s

BF16, FP32 = 2, 4


def mla_work(rows, page_tokens: int, a) -> tuple:
    """(bytes, flops) of one #7 call (one layer) over ``rows`` of ``(n,
    q_len)``: ``n`` the row's tokens after the call."""
    page_bytes = page_tokens * (a.dc + a.dr) * BF16
    pair_flops = a.H * (2 * (a.dc + a.dr) + 2 * a.dc)
    nbytes, flops = 0, 0
    for n, ql in rows:
        if ql <= 0:
            continue
        nbytes += (-(-n // page_tokens) * page_bytes
                   + ql * a.H * (2 * a.dc + a.dr) * FP32)
        flops += pair_flops * (ql * (n - ql) + ql * (ql + 1) // 2)
    return nbytes, flops


def expert_work(rows: int, experts_run: int, a) -> tuple:
    """(bytes, flops) of the held experts' products over ``rows`` (token,
    expert) rows that gave ``experts_run`` experts work."""
    weights = 3 * a.d * a.f * BF16
    return (experts_run * weights + rows * 2 * a.d * BF16,
            rows * 6 * a.d * a.f)


def expert_bound_s(rows: int, experts_run: int, a) -> float:
    return bound_s(*expert_work(rows, experts_run, a))


def _attn_params(a) -> int:
    qk = a.dn + a.dr
    q = (a.d * a.q_lora + a.q_lora * a.H * qk) if a.q_lora else a.d * a.H * qk
    return q + a.d * (a.dc + a.dr) + a.H * a.dv * a.d


def token_flops(a) -> int:
    """Useful operations of one token through every layer, the pairs, the
    held experts and the head left out."""
    attn = 2 * _attn_params(a) + 2 * a.H * a.dc * (a.dn + a.dv)
    dense = 2 * 3 * a.d * a.F
    moe = 2 * a.d * a.E + 2 * 3 * a.d * a.f * a.n_shared
    return a.L * attn + a.n_dense * dense + a.n_moe * moe


def span_flops(a, start: int, n: int, head_rows: int) -> int:
    """Useful operations of ``n`` tokens at positions ``start .. start +
    n - 1`` of one sequence, the held experts left out (they count by
    the rows the program computed: :func:`expert_flops`)."""
    pairs = n * start + n * (n + 1) // 2
    return (n * token_flops(a)
            + a.L * a.H * (2 * (a.dc + a.dr) + 2 * a.dc) * pairs
            + 2 * head_rows * a.V * a.d)


def expert_flops(a, rows: int) -> int:
    """Useful operations of ``rows`` (token, held expert) rows."""
    return rows * 6 * a.d * a.f
