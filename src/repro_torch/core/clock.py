"""Simulated-time accounting for the tiered cache (DESIGN.md §2).

All data movement in ``repro_torch.core`` is functionally real (real bytes move);
*time* is modeled, because the container has neither Optane nor a TPU host
fabric. Costs come from the calibrated tier specs in ``repro_torch.roofline.hw``.

Two actors share the simulation: the foreground application thread and the
background drainer. The drainer is modeled as a single-server queue whose
entry finish-times are computed analytically (arrival/service), so foreground
stalls (log full) and crash cut-offs (which entries are durable at time t)
are exact functions of simulated time.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.roofline.hw import TierSpec


@dataclass
class SimClock:
    now: float = 0.0
    # accounting by (tier, op) for reporting read/write amplification
    tallies: dict = field(default_factory=dict)

    def charge(self, tier: TierSpec, op: str, nbytes: int,
               random_access: bool = True, advance: bool = True) -> float:
        """Account one IO. Returns the cost in seconds."""
        if op == "read":
            bw = tier.rand_read_bw if random_access else tier.read_bw
            lat = tier.read_latency
        else:
            bw = tier.rand_write_bw if random_access else tier.write_bw
            lat = tier.write_latency
        cost = lat + nbytes / bw
        key = (tier.name, op)
        cnt, tot = self.tallies.get(key, (0, 0))
        self.tallies[key] = (cnt + 1, tot + nbytes)
        if advance:
            self.now += cost
        return cost

    def advance(self, seconds: float) -> None:
        self.now += seconds

    def wait_until(self, t: float) -> None:
        if t > self.now:
            self.now = t

    def bytes_moved(self, tier_name: str, op: str) -> int:
        return self.tallies.get((tier_name, op), (0, 0))[1]


@dataclass
class DrainQueue:
    """Analytic single-server queue for the background drainer.

    ``push`` registers a unit of drain work arriving at time ``t`` with
    service time ``svc``; returns the finish time. Entries finish in FIFO
    order: finish_i = max(arrival_i, finish_{i-1}) + svc_i.

    A push may carry a ``token`` naming its reservation, which makes the
    entry *cancellable*: :meth:`cancel` removes a tokened reservation and
    replays the remaining pending entries over the freed server time, so
    ``backlog`` stops counting work that will never run (a released
    sequence's queued transfers). Service the server already performed is
    history — a reservation that finished (or the served part of one in
    mid-service) is never refunded.
    """
    last_finish: float = 0.0

    def __post_init__(self):
        # token → (arrival, service, finish); only tokened pushes are
        # cancellable. _base is the completed-work watermark: server time
        # owed to untracked/settled/served entries that replay must respect.
        self._resv: dict = {}
        self._base: float = 0.0

    def push(self, arrival: float, service: float, token=None) -> float:
        start = max(arrival, self.last_finish)
        self.last_finish = start + service
        if token is not None:
            self._resv[token] = (arrival, service, self.last_finish)
        else:
            self._base = max(self._base, self.last_finish)
        return self.last_finish

    def finish_of(self, token) -> Optional[float]:
        """Current finish time of a tracked reservation (may be earlier
        than the value ``push`` returned if a cancel compacted the queue)."""
        r = self._resv.get(token)
        return None if r is None else r[2]

    def settle(self, token) -> Optional[float]:
        """Retire a tracked reservation (its caller barriered on it): its
        finish joins the completed-work watermark. Returns the finish."""
        r = self._resv.pop(token, None)
        if r is None:
            return None
        self._base = max(self._base, r[2])
        return r[2]

    def cancel(self, token, now: float) -> float:
        """Remove a tracked reservation and reclaim its *unserved* time.

        Entries fully served by ``now`` are history (no refund); the served
        part of a mid-service entry stays on the books. Remaining pending
        entries replay FIFO over the freed timeline — an entry that had
        already started keeps its start (the server cannot un-serve), the
        rest close up behind it. Returns the seconds reclaimed from
        ``last_finish``.
        """
        entry = self._resv.pop(token, None)
        if entry is None:
            return 0.0
        # fold anything fully served into the watermark first
        for tok in [t for t, r in self._resv.items() if r[2] <= now]:
            self._base = max(self._base, self._resv.pop(tok)[2])
        if entry[2] <= now:
            self._base = max(self._base, entry[2])
            return 0.0                      # already drained: no refund
        old = self.last_finish
        _, svc, fin = entry
        # a cancelled mid-service entry occupied the server until `now`
        t = max(self._base, now if fin - svc < now else self._base)
        for tok in sorted(self._resv, key=lambda k: self._resv[k][2]):
            a, s, f = self._resv[tok]
            start = (f - s) if f - s < now else max(a, t)   # started: fixed
            f2 = start + s
            self._resv[tok] = (a, s, f2)
            t = max(t, f2)
        self.last_finish = max(t, self._base)
        return max(0.0, old - self.last_finish)

    def backlog(self, now: float) -> float:
        """Seconds of queued work still draining at time ``now`` (0 when the
        server is idle) — the channel-occupancy gauge the async transfer
        pipeline reports."""
        return max(0.0, self.last_finish - now)


class ShardedDrainer:
    """N independent :class:`DrainQueue` servers sharing one SimClock.

    The per-shard drainer both cache tiers use (``NVLog`` shards its WAL by
    page number, the hybrid KV cache shards its token log by sequence):
    ``shard_of(key)`` hashes a key onto a shard, and each shard drains as an
    independent FIFO server — backlog on one shard never delays another.
    Within a shard, FIFO finish order is what the force-drain coherence rule
    relies on: waiting for a page's (or sequence's) newest entry implies
    every earlier entry of that shard has drained too.
    """

    def __init__(self, shards: int = 1):
        assert shards >= 1, shards
        self.queues = [DrainQueue() for _ in range(shards)]

    @property
    def num_shards(self) -> int:
        return len(self.queues)

    def shard_of(self, key) -> int:
        return hash(key) % len(self.queues)

    def push(self, shard: int, arrival: float, service: float,
             token=None) -> float:
        """Enqueue one unit of drain work on ``shard``; returns finish time."""
        return self.queues[shard].push(arrival, service, token=token)

    def last_finish(self, shard: int) -> float:
        return self.queues[shard].last_finish

    def idle_time(self) -> float:
        """Time by which every shard's backlog has fully drained."""
        return max(q.last_finish for q in self.queues)

    def reset(self) -> None:
        """Drop all queue state (crash: the drainer's backlog is volatile)."""
        for q in self.queues:
            q.last_finish = 0.0
            q._resv.clear()
            q._base = 0.0
