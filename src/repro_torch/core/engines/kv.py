"""KV-cache engine protocol and registry (serving tier of the paper).

``KVCacheEngine`` abstracts the *serving* translation of the paper's
question — how decoded KV tokens move between HBM, host memory, and disk.
Engines construct from :class:`EngineSpec`
(:mod:`repro_torch.core.engines.base`).

``KVCacheEngine`` is the formal contract every tiered KV design implements:

* ``append(seq, kv_tokens)`` — one decoded token ``(L, 2, K, D)`` or a
  prefill batch ``(L, 2, T, K, D)``; durable in the host tier at return.
* ``append_many(items)`` — batched multi-sequence append: one decode step's
  worth of tokens across a whole running batch in one call.
* ``read(seq, layer)`` — materialize ``(2, T, K, D)`` for attention
  (``gather`` is the historical alias and remains supported).
* ``preempt(seq)`` / ``restore(seq)`` — offload a sequence's KV to disk and
  bring it back (continuous batching under memory pressure).
* ``release(seq)`` — drop a finished sequence's state from every tier.
* ``stats`` — monotone counters merged into serving-engine stats.

A scheduler driving preemption reads the *pressure surface* instead of
engine internals: ``pressure()`` (HBM use over budget), ``resident_bytes``
(one sequence's HBM footprint), and ``victim_hint`` (the engine's preferred
preemption victim — ``kvhybrid`` answers from its router's per-sequence
reuse histogram; engines with no opinion return ``None`` and the scheduler
falls back to LRU).

New designs register with ``@register_kv_engine("name")`` and are
constructed via ``create_kv_engine(spec, kvspec, clock)``; unknown names
raise ``ValueError``. The port's built-ins (``paged`` in host or pooled
mode, ``log`` and ``kvhybrid``) live in :mod:`repro_torch.core.kvcache`
and are registered on first use. This registry is the port's own, so its
names never clash with the JAX package's.
"""
from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Iterable, Optional, Sequence

import numpy as np

from repro_torch.core.clock import SimClock
from repro_torch.core.engines.base import EngineSpec

if TYPE_CHECKING:                      # avoid a cycle: kvcache imports us
    from repro_torch.core.kvcache import KVSpec


class KVCacheEngine(abc.ABC):
    """Abstract base for tiered KV-cache designs behind the serving engine."""

    #: registry key, filled in by ``@register_kv_engine``
    engine_name: str = "?"
    #: per-engine counters (monotone); serving merges this into its stats
    stats: dict
    #: seq → appended-token count (the serving engine reads this)
    seq_len: dict

    @classmethod
    @abc.abstractmethod
    def from_spec(cls, spec: EngineSpec, kvspec: "KVSpec",
                  clock: SimClock) -> "KVCacheEngine":
        """Construct the engine from the shared config object.

        ``spec`` carries the pool budget and tiering knobs
        (``kv_hbm_bytes``, ``async_tiering``); ``kvspec`` carries the model
        geometry.
        """

    # ------------------------------------------------------------------- ops
    @abc.abstractmethod
    def append(self, seq: int, kv_tokens: np.ndarray) -> None:
        """Append KV for ``seq``: ``(L, 2, K, D)`` one token, or
        ``(L, 2, T, K, D)`` a batch of ``T`` consecutive tokens (prefill)."""

    def append_many(self, items: Sequence[tuple[int, np.ndarray]]) -> None:
        """Batched multi-sequence append: ``[(seq, kv_tokens), ...]``.

        The continuous-batching decode path: one scheduler step appends one
        token for every running sequence through a single call. The default
        loops; engines override to amortize per-call work (drainer advance)
        across the batch.
        """
        for seq, kv_tokens in items:
            self.append(seq, kv_tokens)

    @abc.abstractmethod
    def read(self, seq: int, layer: int) -> np.ndarray:
        """Materialize ``(2, T, K, D)`` for attention over ``seq``."""

    def gather(self, seq: int, layer: int) -> np.ndarray:
        """Historical alias for :meth:`read`."""
        return self.read(seq, layer)

    @abc.abstractmethod
    def preempt(self, seq: int) -> None:
        """Offload ``seq``'s KV to disk and free its host/HBM state.
        Reading or appending a preempted sequence raises ``RuntimeError``
        until :meth:`restore`."""

    @abc.abstractmethod
    def restore(self, seq: int) -> None:
        """Bring a preempted sequence back into the host tier."""

    @abc.abstractmethod
    def release(self, seq: int) -> None:
        """Drop a finished sequence from every tier (the scheduler calls
        this when a request completes; frees HBM/host/disk state)."""

    # ------------------------------------------------------ pressure surface
    def hbm_used_bytes(self) -> int:
        """Bytes of HBM this engine currently holds resident."""
        return 0

    def hbm_limit_bytes(self) -> Optional[int]:
        """The engine's HBM budget in bytes (``None`` = unbounded)."""
        return None

    def pressure(self) -> float:
        """HBM occupancy as a fraction of the budget (0.0 when unbounded).

        Reaches 1.0 exactly when the budget binds — the scheduler's
        preemption trigger. Engines self-limit, so the value never exceeds
        1.0; "over budget" is expressed as sitting *at* the ceiling.
        """
        limit = self.hbm_limit_bytes()
        if not limit:
            return 0.0
        return self.hbm_used_bytes() / limit

    def resident_bytes(self, seq: int) -> int:
        """HBM bytes attributable to ``seq`` (what preempting it frees)."""
        return 0

    def victim_hint(self, candidates: Iterable[int]) -> Optional[int]:
        """The engine's preferred preemption victim among ``candidates``.

        ``None`` means no opinion — the scheduler falls back to LRU.
        ``kvhybrid`` overrides this to consult its router's per-sequence
        reuse histogram (cold-read-heavy sequences are the cheapest to
        serve from the spilled tier, so they go first); ``paged`` in pooled
        mode answers at page granularity (the candidate whose preemption
        frees the most device pool pages).
        """
        return None

    def can_admit_tokens(self, n_tokens: int) -> bool:
        """Would admitting a sequence of ``n_tokens`` fit right now?

        Engines with hard allocation limits (the pooled paged engine: a
        fixed number of device pool pages) override this so the scheduler
        never admits a sequence it cannot place. The default is True —
        host-tier engines self-limit through ``pressure()`` alone.
        """
        return True

    # ------------------------------------------------- async tier transfers
    # Asynchronous tiering: a pooled engine may move its page
    # spills (D2H) and fault-ins (H2D) through a background transfer
    # pipeline so they overlap the fused forward instead of stalling it.
    # The scheduler publishes next tick's planned batch through prefetch()
    # so spilled pages start their H2D before prepare_step would
    # demand-fault them; the coherence rule is a drain barrier before any
    # read of an in-flight page. Engines without a pipeline keep the no-op
    # defaults — both calls are safe on every engine.

    def prefetch(self, seqs: Sequence[int],
                 n_tokens: Optional[Sequence[int]] = None) -> int:
        """Lookahead hint: the scheduler plans to step ``seqs`` next tick
        (``n_tokens[i]`` advisory slot counts — decode rows ``1 + k``,
        chunk rows their chunk length). An async-tiering engine schedules
        H2D fault-ins for these sequences' spilled pages; the transfers
        drain in the background and the later demand fault only waits for
        the residual time. Purely a timing hint — no allocation and no
        data movement happen here, so prefetching never changes which
        pages spill or fault. Returns the number of transfers scheduled
        (0 on engines without a pipeline)."""
        return 0

    def flush_transfers(self) -> None:
        """Drain every in-flight asynchronous tier transfer (advance the
        clock to the pipeline's idle time). Benchmarks call this before
        reading ``sim_time_s`` so async runs pay for their outstanding
        background traffic; a no-op on engines without a pipeline."""

    # ------------------------------------------------- faults & recovery
    # Hooks the serving fault layer uses. Engines without an
    # async pipeline (log, kvhybrid — no tier transfers to fail) keep the
    # no-op defaults; pooled engines forward them to their TransferPipeline.

    def set_fault_injector(self, injector) -> None:
        """Attach a :class:`~repro_torch.serving.faults.FaultInjector` so
        tier transfers (and spilled-host-page reads) can fail
        deterministically. No-op on engines without a transfer pipeline."""

    def abort_step(self, seqs: Sequence[int]) -> None:
        """Roll back an in-flight prepared step for ``seqs`` (exception
        between ``prepare_step`` and ``commit_step``): unpin the batch and
        drop any pages allocated beyond each row's committed length, so a
        poisoned tick cannot leak pool pages. No-op on unpooled engines."""

    def stall_transfers(self, direction: int, seconds: float) -> None:
        """Inject a drainer-shard stall on one transfer channel (0 = D2H,
        1 = H2D): the channel serves nothing for ``seconds``. Timing-only;
        no-op on engines without a pipeline."""

    # ----------------------------------------------- device-resident KV pool
    # The mirror-free serving path: an engine that supports
    # pooling owns (L, P, T, K, D) device arrays of KV pages; the serving
    # engine decodes *directly* over them with the paged_attention kernel
    # (block-table indirection), so no dense per-sequence mirror and no
    # device→host copy exists on the decode path. Engines that return False
    # from supports_pool() (log, kvhybrid — their layouts are logs, not
    # page pools) transparently stay on the mirrored dense-cache path.

    def supports_pool(self) -> bool:
        """True if this engine can own a device-resident paged KV pool."""
        return False

    @property
    def pooled(self) -> bool:
        """True once :meth:`init_pool` has activated the device pool."""
        return False

    def init_pool(self, dtype=None, pages: Optional[int] = None) -> None:
        """Activate pooled mode: allocate the device page pool (sized from
        the engine's HBM budget unless ``pages`` overrides it). Must be
        called before any append. ``dtype`` defaults to the KVSpec dtype;
        the serving engine passes the model's cache dtype so pooled decode
        is bit-identical to the dense path."""
        raise RuntimeError(
            f"KV engine {self.engine_name!r} has no paged pool; check "
            f"supports_pool() before init_pool()")

    def pool_views(self):
        """The device pool planes in cache-descriptor order — for the
        dense layout the classic ``(pool_k, pool_v)`` pair, each
        ``(L, P, T, K, D)``; other descriptors return their own plane
        tuples (int8 adds scale planes, MLA pools ``(c, kr)``). The
        engine retains ownership — callers must hand updated arrays back
        through :meth:`commit_step_planes` / :meth:`commit_prefill`."""
        raise RuntimeError(
            f"KV engine {self.engine_name!r} has no paged pool")

    def prepare_decode(self, seqs: Sequence[int], max_pages: int):
        """Ready one decode step for ``seqs``: fault every spilled page
        back in, allocate a fresh page for each sequence whose next token
        starts one, and return ``(block_table, lengths)`` — an
        ``(B, max_pages) int32`` table plus current token counts.

        Single-token special case of :meth:`prepare_step`."""
        return self.prepare_step(seqs, [1] * len(seqs), max_pages)

    def commit_decode(self, pool_k, pool_v, seqs: Sequence[int]) -> None:
        """Accept updated pool arrays after the model scattered one new
        token per sequence in ``seqs``; advances ``seq_len`` and the
        resident-page accounting (HBM write charges, no host traffic).

        Single-token special case of :meth:`commit_step`."""
        return self.commit_step(pool_k, pool_v, seqs, [1] * len(seqs))

    def prepare_step(self, seqs: Sequence[int], n_tokens: Sequence[int],
                     max_pages: int):
        """Multi-token generalization of :meth:`prepare_decode` — ready one
        fused mixed-batch step that appends ``n_tokens[i]`` tokens to
        ``seqs[i]`` (decode rows: 1; prefill-chunk rows: up to the chunk
        budget): fault every spilled page back in, allocate pages covering
        each sequence's chunk, and return ``(block_table, ctx_lens)`` —
        ``ctx_lens`` are the token counts BEFORE the step (each row's chunk
        start position)."""
        raise RuntimeError(
            f"KV engine {self.engine_name!r} has no paged pool")

    def commit_step(self, pool_k, pool_v, seqs: Sequence[int],
                    n_tokens: Sequence[int],
                    prepared: Optional[Sequence[int]] = None) -> None:
        """Accept updated pool arrays after the model scattered new tokens
        for ``seqs[i]`` in one fused step; advances ``seq_len`` and the
        resident-page accounting.

        Partial commit (speculative decode): ``n_tokens[i]`` is the number
        of tokens to COMMIT, which may be less than the ``prepared[i]``
        tokens :meth:`prepare_step` was sized for when a speculative tail
        was rejected. Pass the original ``prepare_step`` counts as
        ``prepared`` to roll the tail back: ``seq_len`` advances by the
        accepted count only and pages allocated solely for the rejected
        tail are returned to the free list, so pool pressure never reflects
        tokens that were never committed. Rejected KV left inside retained
        pages is invisible (kernels mask at or past ``lengths``) and is
        overwritten in place by the sequence's next committed tokens.
        ``prepared=None`` (or ``prepared[i] == n_tokens[i]``) is the plain
        full commit."""
        raise RuntimeError(
            f"KV engine {self.engine_name!r} has no paged pool")

    def can_place_step(self, seqs: Sequence[int],
                       n_tokens: Sequence[int]) -> bool:
        """Would :meth:`prepare_step` succeed for this batch right now?

        ``prepare_step`` pins EVERY batch sequence's pages while it
        allocates (a later allocation must never spill a page the kernel is
        about to read), so a fused tick whose chunks need more pages than
        ``free + spillable-from-outside-the-batch`` cannot be placed — the
        scheduler preempts a row and retries instead of crashing into the
        pool-exhausted error. Engines without a pool always say True."""
        return True

    def alloc_prefill(self, seq: int, n_tokens: int):
        """Allocate pages covering ``n_tokens`` upcoming tokens of ``seq``
        and return the sequence's physical-page row (np.int32)."""
        raise RuntimeError(
            f"KV engine {self.engine_name!r} has no paged pool")

    def commit_prefill(self, pool_k, pool_v, seq: int,
                       n_tokens: int) -> None:
        """Accept updated pool arrays after a prompt's KV was scattered
        into ``seq``'s pages on device (the admission path's one
        device-side copy; still zero device→host traffic). Dense
        ``(k, v)`` special case of :meth:`commit_prefill_planes`."""
        raise RuntimeError(
            f"KV engine {self.engine_name!r} has no paged pool")

    # --------------------------------------------------------- prefix sharing
    # Cross-request KV reuse: a prefix index (the token radix trie in
    # repro_torch.serving.prefix_cache) maps shared token prefixes to pool
    # pages; admission of a cache-hit prompt splices the new sequence's
    # block table onto those pages (adopt_pages — zero prefill compute for
    # the covered prefix), the first divergent write triggers copy-on-write
    # of the boundary page, and eviction/spill becomes refcount-aware: a
    # page is freed only when no sequence references it AND the index has
    # unpinned it. The index object registered through set_share_index must
    # provide: ``reclaim_one() -> Optional[int]`` (evict one idle indexed
    # page, freeing it), ``forget_phys(phys)`` (drop the index entry for a
    # page the engine is about to spill), ``on_seq_dropped(seq)`` and
    # ``on_cow(seq, phys)`` (refcount bookkeeping callbacks).

    def supports_sharing(self) -> bool:
        """True when block tables may alias pool pages across sequences
        (refcounted pages + copy-on-write divergence)."""
        return False

    def set_share_index(self, index) -> None:
        """Register the prefix index that pins shared pages (see above)."""
        raise RuntimeError(
            f"KV engine {self.engine_name!r} does not support prefix "
            f"sharing; check supports_sharing() first")

    def adopt_pages(self, seq: int, pages: Sequence[int],
                    covered_tokens: int) -> None:
        """Admission splice: point ``seq``'s (empty) block table at shared
        pool pages covering its first ``covered_tokens`` prompt tokens.
        Pure metadata — refcounts go up, no KV moves, no compute runs."""
        raise RuntimeError(
            f"KV engine {self.engine_name!r} does not support prefix "
            f"sharing")

    def pin_page(self, phys: int) -> None:
        """Index pin: keep ``phys`` alive (and never spilled) even after
        every referencing sequence releases."""
        raise RuntimeError(
            f"KV engine {self.engine_name!r} does not support prefix "
            f"sharing")

    def unpin_page(self, phys: int) -> None:
        """Drop the index pin on ``phys``; frees the page if no sequence
        references it anymore."""
        raise RuntimeError(
            f"KV engine {self.engine_name!r} does not support prefix "
            f"sharing")

    def page_refs(self, phys: int) -> int:
        """Live referents of a pool page: sequences whose block tables
        contain it, plus 1 if the prefix index pins it."""
        return 0

    # ------------------------------------------- descriptor plane surface
    # Cache descriptors: a pooled engine built from a KVSpec
    # carrying a CacheDescriptor owns one device array PER PLANE. The
    # plane-generic commit twins below accept the full plane tuple in
    # descriptor order; the dense (pool_k, pool_v) entries above remain as
    # the two-plane special case.

    def commit_step_planes(self, planes, seqs: Sequence[int],
                           n_tokens: Sequence[int],
                           prepared: Optional[Sequence[int]] = None) -> None:
        """Plane-generic :meth:`commit_step`: ``planes`` is the updated
        pool-plane tuple in cache-descriptor order."""
        raise RuntimeError(
            f"KV engine {self.engine_name!r} has no paged pool")

    def commit_prefill_planes(self, planes, seq: int,
                              n_tokens: int) -> None:
        """Plane-generic :meth:`commit_prefill`."""
        raise RuntimeError(
            f"KV engine {self.engine_name!r} has no paged pool")

    # State-bearing descriptors (SSM) have no pages at all: their per-seq
    # state rows move through state_views()/commit_state() and ride
    # preempt/restore with the row.
    def state_views(self, seqs: Sequence[int]):
        """Batched per-seq state rows for one step — one ``(L, B, *shape)``
        tensor per descriptor seq plane. Only state-bearing descriptors
        (SSM) implement this."""
        raise RuntimeError(
            f"KV engine {self.engine_name!r} has no per-seq state rows")

    def commit_state(self, seqs: Sequence[int], n_tokens: Sequence[int],
                     states) -> None:
        """Commit one step's updated state rows; rows with
        ``n_tokens[i] == 0`` commit nothing (speculative/padding rewind)."""
        raise RuntimeError(
            f"KV engine {self.engine_name!r} has no per-seq state rows")


_KV_REGISTRY: dict[str, type[KVCacheEngine]] = {}


def register_kv_engine(name: str, *, override: bool = False):
    """Class decorator: make a KV engine constructible by name.

    Same duplicate-name guard as the FS registry: silently replacing a
    built-in would corrupt every registry-driven construction site.
    """
    def deco(cls: type[KVCacheEngine]) -> type[KVCacheEngine]:
        if not override and name in _KV_REGISTRY:
            raise ValueError(
                f"KV engine {name!r} is already registered "
                f"({_KV_REGISTRY[name].__name__}); pass override=True to "
                f"replace it")
        cls.engine_name = name
        _KV_REGISTRY[name] = cls
        return cls
    return deco


_builtins_loaded = False


def _ensure_builtins() -> None:
    # the built-in engines live in repro_torch.core.kvcache, which imports this
    # module for the protocol — register them lazily to avoid the cycle.
    # Guarded by a flag, not registry emptiness: a plugin registering before
    # first use must not suppress the built-ins.
    global _builtins_loaded
    if not _builtins_loaded:
        import repro_torch.core.kvcache  # noqa: F401  (registers built-ins)
        _builtins_loaded = True    # only after a successful import: a failed
        # first attempt must retry, not hide the builtins forever


def get_kv_engine(name: str) -> type[KVCacheEngine]:
    _ensure_builtins()
    try:
        return _KV_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown KV engine {name!r}; registered KV engines: "
            f"{', '.join(sorted(_KV_REGISTRY))}") from None


def create_kv_engine(spec: EngineSpec, kvspec: "KVSpec",
                     clock: SimClock) -> KVCacheEngine:
    """Build the KV engine named by ``spec.engine``."""
    return get_kv_engine(spec.engine).from_spec(spec, kvspec, clock)


def list_kv_engines() -> tuple[str, ...]:
    _ensure_builtins()
    return tuple(_KV_REGISTRY)
