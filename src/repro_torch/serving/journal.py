"""Crash-consistent serving journal over the NVMM log tier.

The port's copy of the JAX package's ``ServingJournal``.

The paper's thesis applied to serving: NVLog survives power loss because
every mutation hits a sequential write-ahead log before it is acknowledged,
while page-structured state must be reconstructed. The serving tier's
equivalent of "acknowledged state" is the committed token stream — so each
scheduler tick appends one CRC-framed record of that tick's committed
tokens through the same :class:`~repro_torch.core.wal.CircularWAL` machinery the
log engines persist through, charged to the analytic clock as a sequential
NVMM write (the cheap append the paper measures).

Record format (JSON payloads inside WAL frames):

* tick record  — ``{"t": tick, "c": [[rid, start, [tok, ...]], ...]}``:
  request ``rid`` committed ``len(toks)`` tokens starting at generated
  index ``start``. Records are idempotent under replay (``start`` is an
  absolute index, so re-applying writes the same values in place), which
  is what makes a crash *during recovery* re-replayable.
* snapshot record — ``{"t": tick, "snap": {rid: [tok, ...]}}``: the full
  committed state at compaction time. The WAL is circular; when an append
  finds it full the journal reclaims everything and seeds the new tail
  with a snapshot, so replay never needs records that were reclaimed.

Replay rule: scan durable records oldest→newest (``recover_scan`` stops at
the first torn or out-of-sequence frame — a crash mid-append simply loses
that tick's record, never corrupts earlier ones); a snapshot resets the
state, a tick record overlays its commits. The recovered map {rid →
committed tokens} plus the original request list is everything
:meth:`ServingEngine.recover` needs to rebuild rows and resume decoding.
"""
from __future__ import annotations

import json

from repro_torch.core.wal import CircularWAL
from repro_torch.roofline.hw import NVMM


class ServingJournal:
    """Per-tick committed-token journal with snapshot compaction."""

    def __init__(self, capacity: int = 1 << 20,
                 clock=None, charge_clock: bool = True):
        self.wal = CircularWAL(capacity)
        self.clock = clock
        self.charge_clock = charge_clock
        self._state: dict[int, list] = {}     # rid → committed tokens
        self._tick = -1
        self.stats = {"journal_appends": 0, "journal_bytes": 0,
                      "journal_compactions": 0}

    def attach_clock(self, clock) -> None:
        """A recovered engine re-attaches its (fresh) clock — the WAL region
        survives the crash, the clock does not."""
        self.clock = clock

    # -- append -------------------------------------------------------------
    def _charge(self, nbytes: int) -> None:
        if self.clock is not None and self.charge_clock:
            # sequential NVMM append on the foreground: the WAL persist is
            # the acknowledgement point, so it is critical-path time
            self.clock.charge(NVMM, "write", nbytes, random_access=False)

    def _append(self, obj: dict) -> None:
        payload = json.dumps(obj, separators=(",", ":"),
                             sort_keys=True).encode()
        try:
            self.wal.append(0, payload)
        except BufferError:
            self._compact()
            self.wal.append(0, payload)   # snapshot guarantees room or raises
        self.stats["journal_appends"] += 1
        self.stats["journal_bytes"] += len(payload)
        self._charge(len(payload))

    def append_tick(self, tick: int, commits) -> None:
        """Persist one tick: ``commits`` is ``[(rid, start, tokens), ...]``
        (``start`` = the row's generated length before this tick's tokens).
        Folds the commits into the in-memory state first so a compaction
        triggered by this very append snapshots a superset — replaying the
        tick record over the snapshot is idempotent."""
        for rid, start, toks in commits:
            self._apply(self._state, int(rid), int(start), toks)
        self._tick = tick
        self._append({"t": tick,
                      "c": [[int(rid), int(start),
                             [int(t) for t in toks]]
                            for rid, start, toks in commits]})

    def _compact(self) -> None:
        """Reclaim the full ring and seed it with a snapshot of the current
        committed state. Runs atomically inside an append (crashes fire at
        tick boundaries, never inside one), so the reclaim+snapshot pair is
        never torn apart by a simulated crash."""
        self.wal.reclaim_to(self.wal.head, self.wal.next_seqno)
        payload = json.dumps(
            {"t": self._tick,
             "snap": {str(r): [int(t) for t in toks]
                      for r, toks in sorted(self._state.items())}},
            separators=(",", ":"), sort_keys=True).encode()
        if self.wal.record_size(len(payload)) > self.wal.capacity:
            raise BufferError(
                f"journal capacity {self.wal.capacity} cannot hold one "
                f"snapshot ({len(payload)} bytes); raise the capacity")
        self.wal.append(0, payload)
        self.stats["journal_compactions"] += 1
        self.stats["journal_bytes"] += len(payload)
        self._charge(len(payload))

    @staticmethod
    def _apply(state: dict, rid: int, start: int, toks) -> None:
        lst = state.setdefault(rid, [])
        if start > len(lst):
            raise ValueError(
                f"journal gap for rid {rid}: record starts at {start}, "
                f"only {len(lst)} tokens committed")
        lst[start:start + len(toks)] = [int(t) for t in toks]

    # -- recovery -----------------------------------------------------------
    def replay(self) -> tuple[dict, int]:
        """Post-crash: scan durable records and rebuild the committed-token
        map. Returns ``({rid: [tokens]}, last_durable_tick)``. Also resets
        the in-memory state to the replayed truth so the journal can keep
        appending (a second crash during recovery replays correctly)."""
        state: dict[int, list] = {}
        tick = -1
        for rec in self.wal.recover_scan():
            obj = json.loads(rec.payload)
            if "snap" in obj:
                state = {int(r): list(map(int, toks))
                         for r, toks in obj["snap"].items()}
            else:
                for rid, start, toks in obj["c"]:
                    self._apply(state, int(rid), int(start), toks)
            tick = max(tick, int(obj["t"]))
        self._state = {r: list(t) for r, t in state.items()}
        self._tick = tick
        return state, tick

    def committed(self, rid: int) -> list:
        return list(self._state.get(int(rid), ()))
