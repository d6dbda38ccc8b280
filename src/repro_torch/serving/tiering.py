"""Asynchronous tier-transfer pipeline + hot/cold victim model.

The serving translation of the paper's drain-pipeline lesson: NVLog wins
writes because the log drains in the *background* while the foreground keeps
appending — NVPages pays page-granular transfer latency on the critical
path. The pooled KV engine had exactly the NVPages problem: every D2H page
spill and H2D fault-in stalled the fused tick. This module gives it the
NVLog discipline:

* :class:`TransferPipeline` — two analytic :class:`~repro_torch.core.clock
  .DrainQueue` channels (one per direction, the double-buffer) behind the
  same :class:`~repro_torch.core.clock.ShardedDrainer` machinery the log engines
  drain through. A *submit* tallies the transfer's bytes and enqueues its
  service time without advancing the foreground clock; a *barrier* waits
  for one keyed transfer's finish — the coherence rule is that any read of
  an in-flight page barriers first, and nothing else ever waits.
* :class:`PageHeat` — the deterministic hot/cold re-reference model that
  replaces pure-LRU spill victim selection. Per-page priority is
  ``hotness(p) = freq_ema(p) / (1 + age(p))``: an EMA of access counts
  (the hot/cold split) discounted by a logical age in *touch events*, the
  working-set form of the Che-approximation re-reference probability
  ``P(reuse) ≈ exp(-age / T_c)`` from the hybrid-cache hit-rate model
  (PAPERS.md, "Stochastic Modeling of Hybrid Cache Systems"). Every page
  has the same miss cost (one page-sized H2D), so ranking by re-reference
  probability alone minimizes expected miss cost. Deliberately clock-free
  and sampling-free (grl2's proportional replay priorities, made
  deterministic): victim choice must be bit-identical whether transfers
  run sync or async, or token identity across the two modes breaks.
"""
from __future__ import annotations

from typing import Hashable, Optional

from repro_torch.core.clock import ShardedDrainer, SimClock
from repro_torch.roofline.hw import TierSpec


class TransferPipeline:
    """Double-buffered background D2H/H2D transfer queues over a SimClock.

    Keys are caller-chosen (the pooled engine uses ``("d2h", seq, logical)``
    / ``("h2d", seq, logical)``); one key names at most one in-flight
    transfer. Ordering within a direction is FIFO (one
    :class:`~repro_torch.core.clock.DrainQueue` per direction), and a dependency
    across directions is expressed with ``after=`` — a fault-in chained
    after its page-out's finish time models "the H2D reads the staging
    buffer once the D2H has landed" without stalling the foreground.
    """

    D2H = 0
    H2D = 1

    BACKOFF_CAP = 6           # exponential backoff multiplier capped at 2^6

    def __init__(self, clock: SimClock, stats: Optional[dict] = None,
                 injector=None, max_retries: int = 3,
                 backoff_s: float = 1e-4):
        self.clock = clock
        self.drainer = ShardedDrainer(2)          # shard 0: D2H, shard 1: H2D
        self.stats = stats                        # engine's uniform stats dict
        self.injector = injector                  # FaultInjector or None
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.degraded = False     # terminal failure flipped us to sync tiering
        self._inflight: dict[Hashable, float] = {}   # key → finish time
        # key → (direction, ledger token): which channel holds the live
        # reservation; tokens are unique per submit so a resubmitted key
        # never aliases a stale ledger entry
        self._chan: dict[Hashable, tuple] = {}
        self._epoch: dict[Hashable, int] = {}     # key → submit count
        self._retried: set = set()  # keys whose last submit needed a retry

    def _count(self, name: str, delta: int = 1) -> None:
        if self.stats is not None:
            self.stats[name] = self.stats.get(name, 0) + delta

    def submit(self, direction: int, key: Hashable, tier: TierSpec, op: str,
               nbytes: int, *, random_access: bool = True,
               after: float = 0.0) -> float:
        """Enqueue one background transfer; returns its finish time.

        Tallies the bytes on the clock WITHOUT advancing it (the transfer
        runs beside the foreground); the channel serves it FIFO starting at
        ``max(now, after, channel backlog)``.

        With a fault injector attached, a submission attempt may fail: the
        failed attempt still occupied the channel (history, never refunded),
        and the retry re-enters the FIFO after a capped exponential backoff
        — all charged to the analytic clock, none of it stalling the
        foreground. Past ``max_retries`` the pipeline escalates: it waits
        out the last failed attempt, performs the copy synchronously on the
        foreground clock (the model's always-succeeds slow path), and flips
        ``degraded`` so the engine falls back to synchronous tiering.
        Placement never consults the injector, so faults are timing-only.
        """
        cost = self.clock.charge(tier, op, nbytes,
                                 random_access=random_access, advance=False)
        arrival = max(self.clock.now, after)
        inj = self.injector
        epoch = self._epoch[key] = self._epoch.get(key, 0) + 1
        self._retried.discard(key)
        if inj is not None:
            cost += inj.transfer_delay((key, epoch))
            attempt = 0
            while inj.transfer_fails((key, epoch), attempt):
                # the failed attempt occupied the link: untracked push
                # (history — a later cancel must not reclaim it)
                finish = self.drainer.push(direction, arrival, cost)
                self._count("transfer_failures")
                if attempt >= self.max_retries:
                    # terminal: drain the channel, copy synchronously
                    self.clock.wait_until(finish)
                    self.clock.charge(tier, op, nbytes,
                                      random_access=random_access)
                    self.degraded = True
                    if self.stats is not None:
                        self.stats["tiering_degraded"] = 1
                    self._inflight[key] = self.clock.now
                    self._chan.pop(key, None)
                    return self.clock.now
                self._count("transfer_retries")
                self._retried.add(key)
                attempt += 1
                backoff = self.backoff_s * (1 << min(attempt,
                                                     self.BACKOFF_CAP))
                arrival = finish + backoff
        token = (key, epoch)
        self._inflight[key] = self.drainer.push(direction, arrival, cost,
                                                token=token)
        self._chan[key] = (direction, token)
        return self._inflight[key]

    def finish_of(self, key: Hashable) -> Optional[float]:
        """Finish time of an in-flight transfer, or None."""
        return self._inflight.get(key)

    def took_retries(self, key: Hashable) -> bool:
        """True iff ``key``'s most recent submit needed ≥1 retry; clears
        the flag (the caller classifies the fault once)."""
        if key in self._retried:
            self._retried.discard(key)
            return True
        return False

    def _settle(self, key: Hashable, fallback: float) -> float:
        d = self._chan.pop(key, None)
        if d is None:
            return fallback
        direction, token = d
        f = self.drainer.queues[direction].settle(token)
        return fallback if f is None else f

    def barrier(self, key: Hashable) -> float:
        """Coherence barrier: wait until ``key``'s transfer has finished.
        Returns the foreground stall in seconds — 0.0 when the transfer
        was fully hidden behind compute (or wasn't in flight)."""
        finish = self._inflight.pop(key, None)
        if finish is None:
            return 0.0
        # the ledger may have compacted this entry earlier after a cancel
        finish = min(finish, self._settle(key, finish))
        stall = max(0.0, finish - self.clock.now)
        self.clock.wait_until(finish)
        return stall

    def cancel(self, key: Hashable, reclaim: bool = False) -> bool:
        """Drop the barrier obligation for ``key``. By default the channel
        time already reserved is not refunded — the link was genuinely busy
        (e.g. the staging D2H a chained fault-in read from). With
        ``reclaim=True`` (released sequence, rolled-back speculative pages)
        the unserved portion of the reservation is returned to the channel,
        so backlog stops counting work that will never run."""
        present = self._inflight.pop(key, None) is not None
        d = self._chan.pop(key, None)
        if d is not None:
            direction, token = d
            q = self.drainer.queues[direction]
            if reclaim:
                q.cancel(token, self.clock.now)
            else:
                q.settle(token)
        return present

    def cancel_seq(self, seq: int) -> int:
        """Cancel every in-flight transfer of one sequence (released or
        preempted: its ``(dir, seq, logical)`` keys must not collide with a
        later sequence reusing the id). Unserved channel reservations are
        reclaimed — a released row's queued transfers never run."""
        doomed = [k for k in self._inflight if k[1] == seq]
        for k in doomed:
            self.cancel(k, reclaim=True)
        return len(doomed)

    def stall_channel(self, direction: int, seconds: float) -> float:
        """Inject a drainer-shard stall: the channel serves nothing for
        ``seconds`` starting now (queued transfers finish later). Models a
        stuck drainer shard; foreground is not stalled."""
        self._count("shard_stalls")
        return self.drainer.push(direction, self.clock.now, seconds)

    @property
    def pending(self) -> int:
        return len(self._inflight)

    def backlog_s(self) -> float:
        """Worst per-channel backlog still draining right now."""
        return max(q.backlog(self.clock.now) for q in self.drainer.queues)

    def flush(self) -> float:
        """Full drain: wait for every in-flight transfer; returns the
        stall. Run-end accounting (and whole-pipeline sync points) only —
        per-page barriers are the steady-state coherence mechanism."""
        if not self._inflight:
            return 0.0
        finish = 0.0
        for key, f in list(self._inflight.items()):
            finish = max(finish, min(f, self._settle(key, f)))
        self._inflight.clear()
        self._chan.clear()
        stall = max(0.0, finish - self.clock.now)
        self.clock.wait_until(finish)
        return stall


class PageHeat:
    """Deterministic per-page re-reference estimator for spill ranking.

    ``touch`` advances a global logical tick and bumps the page's access
    EMA; ``hotness`` is that EMA discounted by the page's age in ticks —
    high for pages touched often and recently, decaying toward 0 as a page
    goes cold. ``assign`` resets a physical slot when allocation hands it
    to a new page, so a slot never inherits its previous tenant's heat.
    No wall/sim time enters, so sync and async runs score identically.
    """

    DECAY = 0.5

    def __init__(self):
        self.tick = 0
        self._freq: dict[int, float] = {}
        self._last: dict[int, int] = {}

    def assign(self, phys: int) -> None:
        self._freq[phys] = 0.0
        self._last[phys] = self.tick

    def touch(self, phys: int) -> None:
        self.tick += 1
        self._freq[phys] = 1.0 + self.DECAY * self._freq.get(phys, 0.0)
        self._last[phys] = self.tick

    def hotness(self, phys: int) -> float:
        age = self.tick - self._last.get(phys, self.tick)
        return self._freq.get(phys, 0.0) / (1.0 + age)
