"""Deterministic fault injection for the serving tier.

The port's copy of the JAX package's injector: the same plan makes the
same decisions, bit for bit, as the JAX package's ``FaultInjector``.

The paper's recovery argument only means something if failures are
*replayable*: the same seed must fail the same transfers, lose the same host
pages and crash at the same tick on every run. So the injector is stateless
where it can be — each decision is a pure hash of ``(seed, kind, key,
attempt)`` — and keeps only the minimum mutable state (per-page loss
generations, injection tallies) needed to avoid livelock and to report what
it did.

Two fault families:

* **Transfer faults** (fail / delay a single D2H or H2D submission) are
  consumed by :class:`~repro_torch.serving.tiering.TransferPipeline`. They are
  *timing-only* with respect to token output: the pipeline retries with
  backoff and, past the attempt budget, falls back to a synchronous copy —
  placement decisions never consult the injector, so the decoded stream is
  bit-identical to the fault-free run (pinned by the chaos property test).
* **State faults** (lose a spilled host page, stall a drainer shard, crash
  at a tick boundary) do change engine state and are handled one level up:
  a lost page raises :class:`LostPageError` and the scheduler sheds the row
  back to ``waiting`` for re-prefill; a crash raises :class:`CrashFault`
  after the tick's journal append and :meth:`ServingEngine.recover` replays
  the journal.
"""
from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field
from typing import Optional, Tuple


class CrashFault(RuntimeError):
    """Simulated process crash at a scheduler tick boundary."""

    def __init__(self, tick: int):
        super().__init__(f"injected crash at tick {tick}")
        self.tick = tick


class LostPageError(RuntimeError):
    """A spilled host page is gone (corrupt/lost NVMM-side copy).

    Raised from the demand-fault path; carries the victim sequence so the
    scheduler can shed exactly that row.
    """

    def __init__(self, seq: int, logical: int):
        super().__init__(f"host page lost: seq={seq} logical={logical}")
        self.seq = seq
        self.logical = logical


@dataclass(frozen=True)
class FaultEvent:
    """One scripted fault: fire ``kind`` at scheduler tick ``tick``.

    kinds: ``"shard_stall"`` (key = shard index or None, value = stall
    seconds), ``"page_lost"`` (key = (seq, logical) or seq), ``"crash"``.
    """
    tick: int
    kind: str
    key: object = None
    value: object = None


@dataclass(frozen=True)
class FaultPlan:
    """Seeded rates + optional explicit script. Frozen so a plan can be
    shared between the faulty run and its replay/recovery run."""
    seed: int = 0
    transfer_fail_rate: float = 0.0     # P(one submission attempt fails)
    transfer_delay_rate: float = 0.0    # P(a submission is slowed)
    transfer_delay_s: float = 5e-4      # added service time when delayed
    page_loss_rate: float = 0.0         # P(a spilled host page is lost)
    crash_at_tick: Optional[int] = None
    script: Tuple[FaultEvent, ...] = ()


def _u01(*parts) -> float:
    """Pure uniform(0,1) from a blake2b of the parts — the determinism
    backbone: no RNG state, so injection order cannot perturb decisions."""
    h = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return struct.unpack(">Q", h)[0] / float(1 << 64)


@dataclass
class FaultInjector:
    plan: FaultPlan
    # (seq, logical) → how many times this page was already lost; folded
    # into the loss hash so a re-spilled page rolls a fresh die (else a
    # "lost" page would be lost again forever and the row could livelock
    # through shed → re-prefill → re-spill → lost).
    _loss_gen: dict = field(default_factory=dict)
    _forced_lost: set = field(default_factory=set)   # scripted page losses
    counts: dict = field(default_factory=lambda: {
        "transfer_fail": 0, "transfer_delay": 0, "page_lost": 0,
        "shard_stall": 0, "crash": 0,
    })

    # -- transfer-level hooks (TransferPipeline) ----------------------------
    def transfer_fails(self, key, attempt: int) -> bool:
        r = self.plan.transfer_fail_rate
        if r <= 0.0:
            return False
        if _u01(self.plan.seed, "xfail", key, attempt) < r:
            self.counts["transfer_fail"] += 1
            return True
        return False

    def transfer_delay(self, key) -> float:
        r = self.plan.transfer_delay_rate
        if r <= 0.0:
            return 0.0
        if _u01(self.plan.seed, "xdelay", key) < r:
            self.counts["transfer_delay"] += 1
            return self.plan.transfer_delay_s
        return 0.0

    # -- page-level hook (PagedKVCache._fault_page) -------------------------
    def arm_page_loss(self, key) -> None:
        """Force the next read of one spilled page (``(seq, logical)``, or
        every page of ``seq`` when key is a bare int) to come up lost —
        the scripted-event form of ``page_loss_rate``."""
        self._forced_lost.add(key)

    def page_lost(self, seq: int, logical: int) -> bool:
        if (seq, logical) in self._forced_lost or seq in self._forced_lost:
            self._forced_lost.discard((seq, logical))
            self._forced_lost.discard(seq)
            self.counts["page_lost"] += 1
            return True
        r = self.plan.page_loss_rate
        if r <= 0.0:
            return False
        gen = self._loss_gen.get((seq, logical), 0)
        if _u01(self.plan.seed, "plost", seq, logical, gen) < r:
            self._loss_gen[(seq, logical)] = gen + 1
            self.counts["page_lost"] += 1
            return True
        return False

    # -- tick-level hooks (Scheduler) ---------------------------------------
    def begin_tick(self, tick: int):
        """Scripted events due at this tick (crash events excluded — the
        crash fires *after* the journal append, via :meth:`crash_now`)."""
        out = []
        for ev in self.plan.script:
            if ev.tick == tick and ev.kind != "crash":
                self.counts[ev.kind] = self.counts.get(ev.kind, 0) + 1
                out.append(ev)
        return out

    def crash_now(self, tick: int) -> bool:
        hit = (self.plan.crash_at_tick is not None
               and tick == self.plan.crash_at_tick)
        hit = hit or any(ev.tick == tick and ev.kind == "crash"
                         for ev in self.plan.script)
        if hit:
            self.counts["crash"] += 1
        return hit

    def injected(self) -> int:
        return sum(self.counts.values())
