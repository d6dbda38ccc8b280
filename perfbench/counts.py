"""The yardstick: the card's peaks and the work of a model and its kernels.

Copied into the benchmark so that no change to the program can move it:
the H100's published peaks (NVIDIA's SXM5 data sheet, dense rates, at the
full 700 W), the bytes and operations of a paged-attention call (#1) and
of a flash-attention call (#9), and the useful operations of a dense GQA
decoder's tokens. Imports nothing of the program.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12        # tensor cores, fp32 accumulation
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80 * 10 ** 9


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM bandwidth and the operations over the bf16 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def causal_pairs(sq: int, skv: int, causal: bool = True) -> int:
    """The (query, key) pairs an attention computes: every pair
    non-causal; causal, query ``i`` (at position ``i + skv - sq``) sees
    the keys at or before it."""
    if not causal:
        return sq * skv
    lo = max(0, sq - skv)
    n, first = sq - lo, lo + skv - sq + 1
    return n * first + n * (n - 1) // 2


def flash_work(b: int, sq: int, skv: int, h: int, k: int, d: int, dv: int,
               elt: int = 2, causal: bool = True) -> tuple:
    """(bytes, flops) of one flash-attention call: q, k, v read once and
    the output written once; ``2 (d + dv)`` operations a (query, key) pair
    and query head."""
    nbytes = (b * sq * h * d + b * skv * k * (d + dv) + b * sq * h * dv) * elt
    return nbytes, 2 * (d + dv) * h * b * causal_pairs(sq, skv, causal)


def paged_work(rows, page_tokens: int, h: int, k: int, d: int,
               elt: int = 2) -> tuple:
    """(bytes, flops) of one paged-attention call (one layer) over
    ``rows`` of ``(n, q_len)``: ``n`` the row's tokens after the call,
    ``q_len`` its queries. Each live page of a row with queries is read
    once (K and V), each query read once and its output written once;
    query ``i`` of a row attends to ``n - q_len + i + 1`` keys."""
    page_bytes = page_tokens * k * d * 2 * elt
    nbytes, flops = 0, 0
    for n, ql in rows:
        if ql <= 0:
            continue
        nbytes += -(-n // page_tokens) * page_bytes + 2 * ql * h * d * elt
        flops += 4 * d * h * (ql * (n - ql) + ql * (ql + 1) // 2)
    return nbytes, flops


def layer_matmul_params(a) -> int:
    """The weights one decoder layer multiplies by (``a`` a
    :class:`perfbench.weights.Arch`)."""
    mats = a.layer_matrices()
    return sum(r * c for r, c in mats.values())


def forward_flops(a, n_tokens: int, pairs: int, head_rows: int) -> int:
    """Useful operations of a forward pass over ``n_tokens`` tokens whose
    attention sees ``pairs`` (query, key) pairs in each layer, with
    ``head_rows`` positions through the output head: two a weight a token,
    ``4 d`` a pair and query head (scores and values), two a head weight a
    row. The embedding is a gather and counts nothing."""
    return (2 * n_tokens * a.L * layer_matmul_params(a)
            + 4 * a.D * a.H * a.L * pairs
            + 2 * head_rows * a.V * a.d)


def span_flops(a, start: int, n: int, head_rows: int) -> int:
    """Useful operations of ``n`` tokens at positions ``start ..
    start + n - 1`` of one sequence (each attends to every key up to and
    including its own)."""
    pairs = n * start + n * (n + 1) // 2
    return forward_flops(a, n, pairs, head_rows)


def train_step_flops(a, batch: int, seq: int) -> int:
    """Useful operations of one training step: three forward passes' worth
    (forward, and the backward's two products a weight), logits at every
    position; recomputation counts nothing."""
    return 3 * forward_flops(a, batch * seq,
                             batch * causal_pairs(seq, seq), batch * seq)
