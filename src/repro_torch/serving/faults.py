"""Fault types the serving tier raises and handles.

A lost spilled host page raises :class:`LostPageError` from the demand
-fault path and the scheduler sheds that row back to ``waiting`` for
re-prefill; a crash at a tick boundary raises :class:`CrashFault`. The
deterministic ``FaultPlan``/``FaultInjector`` that inject them wait for a
later slice of the port, so in this package nothing raises them yet — the
scheduler's handlers are ported so the control flow matches the reference.
"""
from __future__ import annotations


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
