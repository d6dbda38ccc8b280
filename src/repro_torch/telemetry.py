"""Named phases of the serving tick and the train step, on the torch
profiler's timeline.

Run the engine or the train step under ``torch.profiler.profile`` and each
scheduler tick shows as a ``repro_torch.tick`` range holding its phases,
each train step as ``repro_torch.train.step`` holding its own, beside the
device's kernels and on the same clock:

* ``repro_torch.tick.admit``: admission (``prefill_one``, the pool
  scatter) and the retirement before the step;
* ``repro_torch.tick.plan``: each decode row's argmax read back to the
  host, the tight-pool guard, the rows and tokens of the step;
* ``repro_torch.tick.prepare``: the step's padded arrays, the pool's block
  table and lengths, their uploads;
* ``repro_torch.tick.forward``: the model step (the host enqueues every
  layer and the head);
* ``repro_torch.tick.commit``: draft verification, the pool commit, the
  rows' bookkeeping, and the scheduler's work after the step;
* ``repro_torch.train.forward``, ``.backward`` (the recompute of a
  rematerialised layer included) and ``.optimizer`` (AdamW);
* inside a forward, each drop-free MoE layer's ``repro_torch.moe.route``
  (the router and the top-k), ``repro_torch.moe.experts`` (the dispatch,
  the held experts' grouped products, the combine) and
  ``repro_torch.moe.shared`` (the shared experts).

While a profiler records, each tick also leaves a :class:`TickRecord` in
:func:`records`: its start and end in ``time.time_ns()`` (the profiler's
timeline) and what the engine's step counters and the scheduler's row
counters moved by in it. The counters count always; a record only takes
their difference at the tick's boundaries. The MoE counters live on the
device (a record's are 0-d tensors, read when the record is): keeping
them reads nothing back.

Recording is the only switch. With no profiler recording, :func:`span`
returns one shared no-op context and no record is kept. The store is one
per process, as the profiler is.
"""
from __future__ import annotations

import contextlib
from collections import deque
from typing import NamedTuple

from torch.autograd import _profiler_enabled as recording
from torch.profiler import record_function

TICK = "repro_torch.tick"
ADMIT = "repro_torch.tick.admit"
PLAN = "repro_torch.tick.plan"
PREPARE = "repro_torch.tick.prepare"
FORWARD = "repro_torch.tick.forward"
COMMIT = "repro_torch.tick.commit"
TRAIN_STEP = "repro_torch.train.step"
TRAIN_FORWARD = "repro_torch.train.forward"
TRAIN_BACKWARD = "repro_torch.train.backward"
TRAIN_OPTIMIZER = "repro_torch.train.optimizer"
MOE_ROUTE = "repro_torch.moe.route"
MOE_EXPERTS = "repro_torch.moe.experts"
MOE_SHARED = "repro_torch.moe.shared"

MAX_RECORDS = 1 << 16

_OFF = contextlib.nullcontext()
_records: deque = deque(maxlen=MAX_RECORDS)


class TickRecord(NamedTuple):
    """One scheduler tick: its bounds (ns, ``time.time_ns()``) and the
    deltas over it of the engine's ``step_stats`` and the scheduler's
    ``SchedulerStats``."""
    start_ns: int
    end_ns: int
    step_slots: int          # Σ Bb × Qb of the tick's ragged steps
    step_tokens: int         # Σ real q_len of those steps
    logit_bytes: int         # bytes of every logits tensor the head returned
    decode_rows: int
    prefill_chunks: int
    # a drop-free MoE model's step counters, 0-d int64 on the device (0
    # for any other model): Σ over its layers of the (token, held expert)
    # pairs computed, the slots routed, the held experts given rows
    expert_rows: object = 0
    routed_slots: object = 0
    experts_run: object = 0


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a
    shared no-op context."""
    if recording():
        return record_function(name)
    return _OFF


def record_tick(start_ns: int, end_ns: int, before: tuple,
                after: tuple) -> None:
    """Keep a tick's record; ``before``/``after`` are the counters in
    :class:`TickRecord`'s order at the tick's start and end."""
    _records.append(TickRecord(start_ns, end_ns,
                               *(a - b for a, b in zip(after, before))))


def records() -> list:
    """The kept :class:`TickRecord` s, oldest first (the newest
    ``MAX_RECORDS``)."""
    return list(_records)


def clear() -> None:
    _records.clear()
