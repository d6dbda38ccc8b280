"""Draft proposers for speculative multi-token decode.

The port's copy of the JAX package's proposers.

Draft-and-verify decoding rides the fused ragged tick: each running decode
row contributes ``1 + k`` query slots — the real next token plus ``k``
drafts — and the model's per-slot logits verify every draft in the same
launch. Accepted runs commit through the engines' partial-commit surface
(``commit_step`` with ``prepared``); rejected tails roll back via the
masked ``mode="drop"`` scatter discipline, so they never become visible
pool or mirror state. Greedy acceptance keeps the committed stream
bit-for-bit identical to ``generate_sequential``, whatever the proposer
suggests — a bad proposer only costs speed, never correctness.

This module holds the proposer side: the :class:`DraftProposer` protocol
(so a small draft model can slot in later) and the default self-drafting
:class:`NGramProposer`.
"""
from __future__ import annotations

from typing import Dict, List, Protocol, Sequence, Tuple, runtime_checkable


@runtime_checkable
class DraftProposer(Protocol):
    """Anything that can guess a row's next tokens.

    The scheduler calls :meth:`propose` once per fused tick per decode
    row with the row's FULL committed token stream (prompt + generated,
    including the tick's own argmax token, which is committed by
    construction). Proposals must be deterministic in ``tokens`` — the
    stream is the only state that survives preemption, so a proposer must
    be rebuildable from it (the scheduler re-feeds the whole stream after
    a restore and on every call). Returning fewer than ``k`` drafts (or
    none) is always legal: the row simply speculates less this tick.

    A model-backed proposer (a small draft config) implements the same
    two methods: ``propose`` runs the draft model greedily over
    ``tokens`` for ``k`` steps; ``drop`` frees its per-row state (e.g.
    the draft model's KV cache row).
    """

    def propose(self, seq: int, tokens: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` draft tokens continuing ``tokens``."""
        ...

    def drop(self, seq: int) -> None:
        """Forget per-sequence state (the row finished or was released)."""
        ...


class NGramProposer:
    """Self-drafting suffix-order n-gram proposer.

    Per sequence, keeps one table per context order ``n ∈ [1, max_n]``
    mapping the last-``n``-token context to the continuation most recently
    observed after it in the committed stream. Proposal walks the suffix
    ladder longest-context-first (order ``max_n`` down to 1) and extends
    greedily until ``k`` drafts are out or no context matches — untrained
    and repetitive streams (greedy argmax loops, templated text) hit the
    high orders almost immediately, which is exactly the decode-heavy
    traffic speculation is for.

    Ingestion is incremental: each :meth:`propose` call feeds only the
    tokens beyond what was already seen, and a diverging prefix (never
    produced by the scheduler, but cheap to guard) rebuilds from scratch.
    State is purely a function of the committed stream, so preemption and
    restore need no hooks here.
    """

    def __init__(self, max_n: int = 3):
        self.max_n = max(int(max_n), 1)
        self._hist: Dict[int, List[int]] = {}
        self._tables: Dict[int, List[Dict[Tuple[int, ...], int]]] = {}

    def _ingest(self, seq: int, tokens: Sequence[int]) -> None:
        hist = self._hist.setdefault(seq, [])
        tables = self._tables.setdefault(
            seq, [{} for _ in range(self.max_n)])
        toks = [int(t) for t in tokens]
        if toks[:len(hist)] != hist:
            hist.clear()
            for t in tables:
                t.clear()
        for i in range(len(hist), len(toks)):
            for n in range(1, min(self.max_n, i) + 1):
                tables[n - 1][tuple(toks[i - n:i])] = toks[i]
            hist.append(toks[i])

    def propose(self, seq: int, tokens: Sequence[int], k: int) -> List[int]:
        self._ingest(seq, tokens)
        tables = self._tables[seq]
        work = list(self._hist[seq])
        out: List[int] = []
        for _ in range(max(int(k), 0)):
            nxt = None
            for n in range(min(self.max_n, len(work)), 0, -1):
                nxt = tables[n - 1].get(tuple(work[-n:]))
                if nxt is not None:
                    break
            if nxt is None:
                break
            out.append(nxt)
            work.append(nxt)
        return out

    def drop(self, seq: int) -> None:
        self._hist.pop(seq, None)
        self._tables.pop(seq, None)
