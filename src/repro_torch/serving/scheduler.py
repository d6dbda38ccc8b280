"""Continuous-batching scheduler with preemption under HBM pressure.

The serving translation of the paper's thesis: log-vs-page tradeoffs only
appear under *concurrent mixed* load, so the engine must actually run
concurrent mixed load. The scheduler keeps three queues:

* **waiting** — submitted, not yet prefetched (FIFO by submission order);
* **running** — sequences decoding (or still prefilling in chunks)
  together; every tick steps ALL of them through a single fused ragged
  forward (see below) whose KV lands in the
  :class:`~repro_torch.core.engines.kv.KVCacheEngine` — in its device
  pool, or mirrored from the rows' dense caches into its host tiers;
* **preempted** — spilled under HBM pressure: the model cache row lives in
  host memory (exact copy), the tiered KV on the disk tier via
  ``KVCacheEngine.preempt``; re-admission restores both.

The port's copy of the JAX package's scheduler; its three ``jnp`` calls
became torch.

State machine::

    waiting --admit/prefill--> running --max_new reached--> finished
                                  |  ^
               pressure >= 1.0 -> |  | re-admit (FIFO, ahead of waiting)
                                  v  |
                               preempted

**Admission** fills the batch up to ``max_batch_seqs`` / ``max_batch_tokens``,
re-admitting preempted sequences ahead of new arrivals (the starvation
guard: a preempted request can only wait behind finitely many decode steps).
New admissions stop while the engine reports full pressure (or, for pooled
engines, while ``can_admit_tokens`` says the page pool cannot place the
candidate), but an empty batch always force-admits — the scheduler never
deadlocks with work queued.

**Chunked prefill**: when a token cap is set, prompts longer than
the chunk budget (``prefill_chunk_tokens``, defaulting to
``max_batch_tokens``) admit with only their first chunk prefilled; the rest
of the prompt rides along as the row's ``pending`` tail and is processed
one chunk per tick before the row joins batched decoding. Chunked rows
preempt/restore like any other row, and the result is token-identical to
one-shot prefill (locked down by test).

**Fused mixed-batch ticks**: on ragged-capable models (the
default) every tick is exactly ONE forward — decode rows argmax their
pending logits and contribute one token, mid-prefill rows contribute their
next chunk, and :meth:`ServingEngine.step_batch` runs them all in the same
ragged launch (chunk rows no longer sit out the batched step or run at
batch=1). A forward-progress guard backs this up: any row that sits in the
running batch without advancing a token or chunk for
``progress_tick_limit`` consecutive ticks raises — the chunk-row
starvation class is a hard error, not a slowdown. ``fuse_ticks=False`` (or
a model family without a ragged step) keeps the old structure: one chunk
per mid-prefill row at batch=1 (``extend_one``), then one batched decode
step over the fully-prefilled rows.

**Preemption** triggers when ``KVCacheEngine.pressure()`` reaches 1.0 (the
engine's HBM accounting has hit its budget). The victim comes from
``victim_hint`` — ``kvhybrid`` answers from its router's per-sequence reuse
histogram (coldest sequence first) — with an LRU fallback for ``paged`` /
``log`` (least recently admitted/restored, ties broken toward the largest
``resident_bytes``). At least ``min_running`` sequences always keep
running, so every tick makes progress and every admitted request finishes.

**Coherence rule:** a sequence is preempted only *between* decode steps,
after its step's KV token has been mirrored (append-then-preempt order), so
the spilled tiered image always equals the model cache row it shadows, and
restore changes no bits. Greedy decode is therefore token-identical to the
sequential reference for ANY admission order, batch size, HBM budget, or
preemption schedule (``tests/test_scheduler.py`` locks this down).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.serving import batching
from repro_torch.serving.faults import CrashFault, LostPageError

if TYPE_CHECKING:                      # engine.py imports us for generate()
    from repro_torch.serving.engine import Request, ServingEngine


@dataclass
class _Running:
    """A sequence in the running batch: its batch-1 model-cache row, the
    logits its next token will be argmaxed from, and LRU bookkeeping."""
    req: "Request"
    cache: dict                        # device arrays, batch dim 1
    logits: object                     # (1, 1, V) device array; None for a
                                       # freshly spliced row (its first chunk
                                       # pass produces the first logits)
    length: int                        # tokens in the cache row (pos)
    mirrored: bool                     # has KV in the tiered engine
    admitted_tick: int                 # last admission/restore tick (LRU)
    pending: Optional[np.ndarray] = None   # unprocessed prompt tail (chunked)
    stalled_ticks: int = 0             # consecutive running ticks w/o advance


@dataclass
class _Preempted:
    """A spilled sequence: model cache row in host memory, tiered KV on the
    disk tier (when the family mirrors KV at all)."""
    req: "Request"
    cache: dict                        # host tensors
    logits: object                     # host tensor (or None)
    length: int
    mirrored: bool
    pending: Optional[np.ndarray] = None
    stalled_ticks: int = 0


@dataclass
class SchedulerStats:
    """Scheduler-level counters (engine-level ones live in tiered.stats)."""
    ticks: int = 0
    admitted: int = 0
    finished: int = 0
    preempts: int = 0
    restores: int = 0
    peak_running: int = 0
    prefill_chunks: int = 0            # chunk-continuation rows stepped
    fused_ticks: int = 0               # ticks run as ONE mixed ragged step
    stalled_row_ticks: int = 0         # running rows that missed a tick (0!)
    spliced: int = 0                   # admissions served from the prefix
                                       # cache (block-table splice, zero
                                       # prefill compute for the covered part)
    decode_rows: int = 0               # decode row-launches: one per decode
                                       # row per tick; with speculation each
                                       # commits 1 + accepted tokens, so
                                       # committed/decode_rows > 1 is the
                                       # accepted-tokens-per-launch win
    rows_shed: int = 0                 # rows shed back to waiting after a
                                       # lost spilled host page —
                                       # re-prefilled, never token-divergent
    degraded_ticks: int = 0            # ticks run with the transfer pipeline
                                       # in degraded (synchronous) mode

    def as_dict(self) -> dict:
        return {f"sched_{k}": v for k, v in self.__dict__.items()}


class Scheduler:
    """Drives one batch of requests to completion over a ServingEngine."""

    def __init__(self, engine: "ServingEngine", requests: list["Request"]):
        self.engine = engine
        cfg = engine.cfg
        self.max_batch_seqs = max(cfg.max_batch_seqs, 1)
        self.max_batch_tokens: Optional[int] = cfg.max_batch_tokens
        self.chunk_tokens: Optional[int] = (cfg.prefill_chunk_tokens
                                            or cfg.max_batch_tokens)
        self.min_running = max(cfg.min_running, 1)
        self.progress_tick_limit = max(getattr(cfg, "progress_tick_limit", 4),
                                       1)
        self.waiting: deque["Request"] = deque(requests)
        self.running: list[_Running] = []
        self.preempted: deque[_Preempted] = deque()
        self.stats = SchedulerStats()

    # -------------------------------------------------------------- admission
    def _batch_tokens(self) -> int:
        return sum(r.length for r in self.running)

    def _has_room(self, cand_tokens: int) -> bool:
        if len(self.running) >= self.max_batch_seqs:
            return False
        if not self.running:
            return True                # force progress: never deadlock
        if self.engine.tiered.pressure() >= 1.0:
            return False               # admitting now would preempt someone
        if not self.engine.tiered.can_admit_tokens(cand_tokens):
            return False               # pooled: no pages to place it
        if self.max_batch_tokens is not None and \
                self._batch_tokens() + cand_tokens > self.max_batch_tokens:
            return False
        return True

    def _first_chunk(self, prompt_len: int) -> int:
        """Tokens the admission prefill processes (the rest rides as the
        row's pending tail)."""
        if self.chunk_tokens is None:
            return prompt_len
        return min(prompt_len, max(self.chunk_tokens, 1))

    @staticmethod
    def _full_prompt(req: "Request") -> np.ndarray:
        """The token prefix admission must prefill: the prompt, plus any
        already-committed tokens for a row that re-enters the waiting queue
        (shed after a lost host page, or rebuilt by crash recovery)."""
        if not req.generated:
            return req.prompt
        prompt = np.asarray(req.prompt)
        return np.concatenate(
            [prompt, np.asarray(req.generated, dtype=prompt.dtype)])

    def _admit(self) -> None:
        # preempted sequences re-admit ahead of new arrivals (starvation
        # guard: FIFO, and nothing can overtake them). A row mid-prefill
        # re-admits against its NEXT CHUNK, not one token — restoring a
        # row whose chunk cannot be placed would bounce it straight back
        # through the fused tick's tight-pool guard (restore/preempt churn
        # with no progress)
        while self.preempted and self._has_room(
                self.preempted[0].length + (
                    self._chunk_len(self.preempted[0].pending)
                    if self.preempted[0].pending is not None
                    and len(self.preempted[0].pending) else 1)):
            pre = self.preempted.popleft()
            if pre.mirrored:
                self.engine.tiered.restore(pre.req.rid)
            self.running.append(_Running(
                req=pre.req,
                cache=batching.row_to_device(pre.cache, self.engine.device),
                logits=(None if pre.logits is None
                        else pre.logits.to(self.engine.device)),
                length=pre.length,
                mirrored=pre.mirrored, admitted_tick=self.stats.ticks,
                pending=pre.pending, stalled_ticks=pre.stalled_ticks))
            self.stats.restores += 1
        while self.waiting and self._has_room(
                self._first_chunk(len(self._full_prompt(self.waiting[0])))
                + 1):
            req = self.waiting.popleft()
            # effective prompt: a shed or crash-recovered row re-prefills
            # its prompt PLUS its already-committed tokens —
            # greedy decode then resumes exactly where the committed
            # stream left off, so degradation never diverges tokens
            full = self._full_prompt(req)
            # prefix-cache splice: a cached prefix admits as a
            # block-table alias — no prefill launch for the covered tokens;
            # the uncovered tail rides as the row's pending chunk tail and
            # its first chunk pass produces the row's first logits
            spliced = (self.engine.admit_prefix(req)
                       if not req.generated else None)
            if spliced is not None:
                cache, covered = spliced
                self.running.append(_Running(
                    req=req, cache=cache, logits=None, length=covered,
                    mirrored=True, admitted_tick=self.stats.ticks,
                    pending=req.prompt[covered:]))
                self.stats.admitted += 1
                self.stats.spliced += 1
                continue
            first = self._first_chunk(len(full))
            logits, cache = self.engine.prefill_one(req, first, tokens=full)
            pending = full[first:] if first < len(full) else None
            self.running.append(_Running(
                req=req, cache=cache, logits=logits, length=first,
                mirrored="k" in cache or self.engine.pooled,
                admitted_tick=self.stats.ticks, pending=pending))
            if pending is None:
                self.engine.on_prompt_complete(req.rid, full)
            self.stats.admitted += 1
        self.stats.peak_running = max(self.stats.peak_running,
                                      len(self.running))

    # ------------------------------------------------------------------ step
    def _chunk_len(self, pending) -> int:
        if self.chunk_tokens is None:
            return len(pending)
        return min(max(self.chunk_tokens, 1), len(pending))

    def _prefill_chunks(self) -> None:
        """UNFUSED fallback: advance every mid-prefill row by one chunk
        (through the decode path at batch=1). Rows still holding a pending
        tail sit out the batched decode step — their logits only become
        meaningful once the whole prompt has been processed."""
        for r in self.running:
            if r.pending is None or not len(r.pending):
                r.pending = None
                continue
            m = self._chunk_len(r.pending)
            r.logits, r.cache = self.engine.extend_one(
                r.req.rid, r.cache, r.pending[:m], r.length, r.mirrored)
            r.length += m
            r.pending = r.pending[m:] if m < len(r.pending) else None
            if r.pending is None:
                self.engine.on_prompt_complete(r.req.rid, r.req.prompt)
            self.stats.prefill_chunks += 1

    def _step(self) -> None:
        """UNFUSED fallback: one batched decode step over every
        fully-prefilled running sequence — argmax each row's pending
        logits, decode all rows at once through
        :meth:`ServingEngine.decode_batch`, split the rows back out."""
        rows = [r for r in self.running if r.pending is None]
        if not rows:
            return
        tokens = []
        with telemetry.span(telemetry.PLAN):
            for r in rows:
                nxt = int(torch.argmax(r.logits[:, -1], -1)[0])
                r.req.generated.append(nxt)
                tokens.append(nxt)
                self.stats.decode_rows += 1
        # one batch = one model family, so either every row mirrors or none
        try:
            logits, caches = self.engine.decode_batch(
                [r.req.rid for r in rows], [r.cache for r in rows], tokens,
                rows[0].mirrored)
        except Exception:
            # the argmaxed tokens were appended BEFORE the model step: a
            # failed step (poisoned tick, lost host page) must pop them or
            # the retried tick would double-append and diverge
            for r in rows:
                r.req.generated.pop()
            raise
        with telemetry.span(telemetry.COMMIT):
            for i, r in enumerate(rows):
                r.cache = caches[i]
                r.logits = logits[i:i + 1]
                r.length += 1

    def _plan_decode(self, r: _Running, k: int):
        """Plan a decode row's tick: argmax its pending logits (the one
        token sequential decode would emit — nothing is committed here, so
        a row the tight-pool guard sheds re-plans identically later) and,
        with speculation on, propose up to ``k`` drafts capped so the row
        can neither outrun ``max_new`` nor its ``max_len`` cache/page span.
        The proposer sees the full committed stream plus the argmaxed
        token — all derivable state, so preemption needs no proposer
        hooks."""
        nxt = int(torch.argmax(r.logits[:, -1], -1)[0])
        drafts: list = []
        if k:
            room = min(self.engine.cfg.max_len - (r.length + 1),
                       r.req.max_new - len(r.req.generated) - 1)
            if room > 0:
                hist = ([int(t) for t in r.req.prompt]
                        + [int(t) for t in r.req.generated] + [nxt])
                drafts = self.engine.proposer.propose(
                    r.req.rid, hist, min(k, room))
        return nxt, drafts

    def _fused_step(self) -> None:
        """The tentpole: ONE fused forward over the whole running batch —
        decode rows argmax their pending logits and contribute ``1 + k``
        tokens (the next token plus up to ``speculate_k`` drafts, verified
        by the same launch's per-slot logits), mid-prefill rows contribute
        their next chunk (no more batch=1 chunk launches), and everyone
        advances in the same ragged launch through
        :meth:`ServingEngine.step_batch`. A chunk row whose tail empties
        this tick comes out holding its prompt-final logits, exactly as
        one-shot prefill would have left it; a speculative row comes out
        holding its last ACCEPTED slot's logits, exactly as sequential
        decode would after the same tokens."""
        with telemetry.span(telemetry.PLAN):
            for r in self.running:
                if r.pending is not None and not len(r.pending):
                    r.pending = None
            # plan every decode row's tokens up front so the tight-pool guard
            # below sheds against the true per-row slot counts (1 + drafts),
            # not an assumed single token
            k = self.engine.speculate_k
            plan = {r.req.rid: self._plan_decode(r, k)
                    for r in self.running if r.pending is None}
            # tight-pool guard: prepare_step pins every batch row while it
            # allocates chunk pages, so a pool that cannot place this tick's
            # chunks with the whole batch pinned must shed a row FIRST —
            # graceful preemption instead of the pool-exhausted hard error.
            # Placement beats the min_running floor here (an unplaceable step
            # makes no progress at all); the liveness floor guarantees a lone
            # row always places (the draft cap keeps even a speculative row
            # inside one max_len page span), so shedding always terminates.
            while len(self.running) > 1 and \
                    not self.engine.can_step_fused(
                        [r.req.rid for r in self.running],
                        [self._chunk_len(r.pending) if r.pending is not None
                         else 1 + len(plan[r.req.rid][1])
                         for r in self.running]):
                self._preempt_one()
            rows, toks, spec, appended = [], [], [], []
            for r in self.running:
                if r.pending is not None:
                    m = self._chunk_len(r.pending)
                    rows.append(r)
                    toks.append(np.asarray(r.pending[:m], np.int32))
                    spec.append(0)
                    appended.append(0)
                    self.stats.prefill_chunks += 1
                else:
                    nxt, drafts = plan[r.req.rid]
                    r.req.generated.append(nxt)
                    rows.append(r)
                    toks.append(np.asarray([nxt] + drafts, np.int32))
                    spec.append(len(drafts))
                    appended.append(1)
                    self.stats.decode_rows += 1
        try:
            logits, caches, committed = self.engine.step_batch(
                [r.req.rid for r in rows], [r.cache for r in rows], toks,
                rows[0].mirrored, spec_lens=spec)
        except Exception:
            # decode rows appended their argmaxed token BEFORE the fused
            # forward: a failed step (poisoned tick, lost host page) must
            # pop them, or the row would double-append when it re-plans —
            # the plan is pure (argmax of unchanged logits), so the retried
            # tick replans the identical token
            for r, a in zip(rows, appended):
                if a:
                    r.req.generated.pop()
            raise
        with telemetry.span(telemetry.COMMIT):
            self.stats.fused_ticks += 1
            for i, r in enumerate(rows):
                r.cache = caches[i]
                r.logits = logits[i]
                m = committed[i]
                if spec[i]:
                    # the argmaxed token is already in generated; the accepted
                    # drafts (tokens 1..m-1 of the row) extend it — the exact
                    # sequential greedy run, rejected tail already rolled back
                    r.req.generated.extend(int(t) for t in toks[i][1:m])
                r.length += m
                if r.pending is not None:
                    r.pending = r.pending[m:] if m < len(r.pending) else None
                    if r.pending is None:
                        self.engine.on_prompt_complete(r.req.rid, r.req.prompt)

    def _check_progress(self, lengths_before: dict) -> None:
        """Forward-progress guard (the chunk-row starvation pin): every row
        that sat in the running batch this tick must have advanced by at
        least one token or chunk within ``progress_tick_limit`` consecutive
        such ticks — a row holding a pending prefill tail must never
        silently sit out ticks while pressure churns. Rows the tick
        preempted BEFORE they could step (the tight-pool guard) count too:
        restore→preempt churn without progress is the same starvation in a
        different queue."""
        def observe(row, rid, pending):
            if row.length > lengths_before.get(rid, -1):
                row.stalled_ticks = 0
                return
            row.stalled_ticks += 1
            self.stats.stalled_row_ticks += 1
            if row.stalled_ticks >= self.progress_tick_limit:
                raise RuntimeError(
                    f"scheduler starvation: request {rid} sat in the "
                    f"running batch for {row.stalled_ticks} ticks without "
                    f"advancing a token or prefill chunk (pending tail: "
                    f"{0 if pending is None else len(pending)} tokens)")

        for r in self.running:
            observe(r, r.req.rid, r.pending)
        for p in self.preempted:
            if p.req.rid in lengths_before:    # was running at tick start
                observe(p, p.req.rid, p.pending)

    def _finish_done(self) -> None:
        still = []
        for r in self.running:
            if len(r.req.generated) >= r.req.max_new:
                r.req.done = True
                if r.mirrored:
                    self.engine.tiered.release(r.req.rid)
                if self.engine.proposer is not None:
                    self.engine.proposer.drop(r.req.rid)
                self.stats.finished += 1
            else:
                still.append(r)
        self.running = still

    # ------------------------------------------------------------ preemption
    def _pick_victim(self) -> _Running:
        candidates = [r for r in self.running]
        hint = self.engine.tiered.victim_hint(
            [r.req.rid for r in candidates if r.mirrored])
        if hint is not None:
            return next(r for r in candidates if r.req.rid == hint)
        # LRU fallback: least recently (re)admitted, ties toward the row
        # whose preemption frees the most HBM
        return min(candidates, key=lambda r: (
            r.admitted_tick, -self.engine.tiered.resident_bytes(r.req.rid)))

    def _over_budget(self) -> bool:
        """HBM pressure at the ceiling, or the running batch has decoded
        its way past the token cap (admission checks only the first step's
        headroom; growth is reclaimed here)."""
        if self.engine.tiered.pressure() >= 1.0:
            return True
        return (self.max_batch_tokens is not None
                and self._batch_tokens() > self.max_batch_tokens)

    def _preempt_one(self) -> None:
        victim = self._pick_victim()
        self.running.remove(victim)
        if victim.mirrored:
            self.engine.tiered.preempt(victim.req.rid)
        self.preempted.append(_Preempted(
            req=victim.req, cache=batching.row_to_host(victim.cache),
            logits=(None if victim.logits is None
                    else victim.logits.to("cpu", copy=True)),
            length=victim.length,
            mirrored=victim.mirrored, pending=victim.pending,
            stalled_ticks=victim.stalled_ticks))
        self.stats.preempts += 1

    def _preempt_under_pressure(self) -> None:
        while self._over_budget() and \
                len(self.running) > self.min_running:
            self._preempt_one()

    # --------------------------------------------------- faults & shedding
    def _shed_seq(self, seq: int) -> None:
        """Graceful degradation for a lost spilled host page:
        the row's pool state is suspect, so release ALL of it and send the
        request back to the FRONT of the waiting queue — re-admission
        re-prefills ``prompt + generated`` and greedy decode resumes
        exactly where the committed stream stopped. Tokens never diverge;
        the row only pays the re-prefill."""
        row = next((r for r in self.running if r.req.rid == seq), None)
        if row is None:
            return
        self.running.remove(row)
        if row.mirrored:
            self.engine.tiered.release(seq)
        if self.engine.proposer is not None:
            self.engine.proposer.drop(seq)
        self.waiting.appendleft(row.req)
        self.stats.rows_shed += 1

    # ------------------------------------------------------------------- run
    def tick(self) -> bool:
        """One scheduling round: admit → step → journal → retire finished →
        preempt under pressure → progress check → (maybe) crash. On the
        fused path (the default for ragged-capable models) the step is ONE
        mixed ragged forward over decode rows and prefill-chunk rows
        together; the unfused fallback (``fuse_ticks=False`` or a family
        without a ragged step) keeps the chunk-at-batch-1 then
        batched-decode structure. Returns False when all work is done.

        Fault hooks: scripted injector events fire at tick
        start; a :class:`LostPageError` from the step sheds exactly the
        losing row back to waiting (the step committed nothing — the
        pre-appended argmax tokens were popped by the step wrappers); the
        tick's committed tokens append to the journal BEFORE a scripted
        crash fires, so every durable tick is replayable — a crash placed
        before the append would simply lose that tick's tokens and
        recovery would re-decode them identically.

        While a profiler records, the tick and its phases are profiler
        ranges (:mod:`repro_torch.telemetry`) and the tick leaves a
        :class:`~repro_torch.telemetry.TickRecord`."""
        if not telemetry.recording():
            return self._tick()
        with telemetry.span(telemetry.TICK):
            start, before = time.time_ns(), self._counts()
            try:
                return self._tick()
            finally:
                telemetry.record_tick(start, time.time_ns(), before,
                                      self._counts())

    def _counts(self) -> tuple:
        """The counters a tick record differences, in its order."""
        st = self.engine.step_stats
        return (st["step_slots"], st["step_tokens"], st["logit_bytes"],
                self.stats.decode_rows, self.stats.prefill_chunks,
                st["expert_rows"], st["routed_slots"], st["experts_run"])

    def _tick(self) -> bool:
        with telemetry.span(telemetry.ADMIT):
            self._admit()
            self._finish_done()    # max_new=0 rows retire without decoding
        if not self.running:
            return bool(self.waiting or self.preempted)
        self.stats.ticks += 1
        inj = self.engine.injector
        if inj is not None:
            for ev in inj.begin_tick(self.stats.ticks):
                if ev.kind == "shard_stall":
                    self.engine.tiered.stall_transfers(
                        int(ev.key or 0), float(ev.value or 1e-3))
                elif ev.kind == "page_lost":
                    inj.arm_page_loss(ev.key)
        lengths_before = {r.req.rid: r.length for r in self.running}
        gen_before = {r.req.rid: len(r.req.generated) for r in self.running}
        shed = None
        try:
            if self.engine.fused:
                self._fused_step()
            else:
                self._prefill_chunks()
                self._step()
        except LostPageError as e:
            self._shed_seq(e.seq)
            shed = e
        with telemetry.span(telemetry.COMMIT):
            if self.engine.journal is not None:
                commits = [(r.req.rid, gen_before[r.req.rid],
                            r.req.generated[gen_before[r.req.rid]:])
                           for r in self.running
                           if r.req.rid in gen_before
                           and len(r.req.generated) > gen_before[r.req.rid]]
                if commits:
                    self.engine.journal.append_tick(self.stats.ticks,
                                                    commits)
            if self.engine.degraded():
                self.stats.degraded_ticks += 1
            self._finish_done()
            self._preempt_under_pressure()
            if shed is None:
                # a shed tick made no progress by design (the injected
                # loss aborted the whole step) — that is degradation, not
                # the starvation class the progress guard hunts
                self._check_progress(lengths_before)
            self._publish_plan()
        if inj is not None and inj.crash_now(self.stats.ticks):
            raise CrashFault(self.stats.ticks)
        return bool(self.waiting or self.running or self.preempted)

    def _publish_plan(self) -> None:
        """Tell the engine what next tick's batch looks like:
        every surviving running row plus how many token slots it will claim
        — its next chunk length mid-prefill, ``1 + speculate_k`` decoding.
        The async tiering pipeline uses this to prefetch spilled pages
        before ``prepare_step`` demand-faults them; on sync or non-pooled
        engines the publication is a no-op."""
        if not self.running:
            return
        seqs, ntoks = [], []
        k = self.engine.speculate_k
        for r in self.running:
            seqs.append(r.req.rid)
            ntoks.append(self._chunk_len(r.pending)
                         if r.pending is not None and len(r.pending)
                         else 1 + k)
        self.engine.publish_plan(seqs, ntoks)

    def run(self) -> None:
        while self.tick():
            pass
