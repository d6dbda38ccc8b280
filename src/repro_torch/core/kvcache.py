"""Tiered KV cache for serving: paged vs log vs hybrid, on a torch device.

The port's copy of the JAX package's KV engines. Tiers: HBM (fast, small)
↔ host DRAM over PCIe (big) ↔ disk (preempted sequences). Every design is
a :class:`~repro_torch.core.engines.kv.KVCacheEngine` built from an
:class:`~repro_torch.core.engines.EngineSpec`
(``create_kv_engine(spec, kvspec, clock)``):

* ``paged`` (:class:`PagedKVCache`, NVPages) runs in one of two modes that
  share the block table. **Pooled** (:meth:`PagedKVCache.init_pool`, the
  mirror-free serving path): fixed-size token pages live in
  device-resident ``(L, P, T, *shape)`` tensors (one per descriptor
  plane) that the paged-attention kernel reads through the block table;
  when the pool fills, the coldest page of a non-pinned sequence spills
  to the host at page granularity and faults back on demand. Pages may
  be shared: a prefix index pins them, admission splices them, and the
  first write inside a shared page copies it (copy-on-write); a fault
  injector may fail tier transfers and lose spilled host pages. **Host
  mode** (the default, behind the dense mirror): pages live in a host
  pool, an HBM LRU models the device working set, appends pay the 2×
  redo + page host write, misses DMA whole pages up.
* ``log`` (:class:`LogKVCache`, NVLog): appends go to one sequential host
  log (1× write); a per-sequence hot window holds the most recent tokens;
  a sharded background drainer compacts log entries into host pages;
  cold reads patch pages from the undrained log, entry by entry.
* ``kvhybrid`` (:class:`HybridKVCache`): small appends take the log path,
  large ones go straight to pages, the threshold learned online
  (:class:`AdaptiveRouter`); a sequence's shard force-drains before the
  page side takes its pages (log-before-pages ordering).

Host-tier data (host pages, the log, hot windows, compacted pages, disk
blobs) are CPU torch tensors — numpy has no bfloat16. Data movement is
real; PCIe/HBM/disk *time* is modelled by the SimClock with the tier
constants the JAX package charges (``HOST_LINK`` and ``HBM`` below), so
byte counters and simulated-time counters compare 1:1 with the
reference. They are a simulation's inputs, not a GPU's speed.

The SSM family pools no pages: its cache is one fixed-size state row per
sequence (the descriptor's ``conv``/``ssm`` seq planes) that rides beside
the block tables — committed with the row each step
(:meth:`PagedKVCache.commit_state`), spilled and restored whole on
preemption.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.clock import ShardedDrainer, SimClock
from repro_torch.core.engines.base import EngineSpec
from repro_torch.core.engines.desc import (CacheDescriptor, PLANE_STAT_NAMES,
                                           dense_descriptor)
from repro_torch.core.engines.kv import KVCacheEngine, register_kv_engine
from repro_torch.core.lru import LRUList
from repro_torch.roofline.hw import SSD, TierSpec

# PCIe gen4 x16-ish host link as seen from the device, and the reference's
# modelled HBM tier (simulated time only — not the port's device)
HOST_LINK = TierSpec("host", read_bw=16e9, write_bw=16e9,
                     rand_read_bw=4e9, rand_write_bw=4e9,
                     read_latency=5e-6, write_latency=5e-6)
HBM = TierSpec("hbm", read_bw=819e9, write_bw=819e9,
               rand_read_bw=400e9, rand_write_bw=400e9,
               read_latency=1e-6, write_latency=1e-6)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class KVSpec:
    num_layers: int
    kv_heads: int
    head_dim: int
    page_tokens: int = 16
    dtype: torch.dtype = torch.float16
    #: optional cache descriptor naming the pool's planes; None resolves to
    #: the dense (k, v) layout in ``dtype``
    desc: Optional[CacheDescriptor] = None

    def descriptor(self) -> CacheDescriptor:
        if self.desc is not None:
            return self.desc
        return dense_descriptor(self.num_layers, self.kv_heads,
                                self.head_dim, self.page_tokens,
                                dtype=self.dtype)

    @property
    def token_bytes(self) -> int:          # K+V for one token, one layer
        return (2 * self.kv_heads * self.head_dim
                * torch.empty((), dtype=self.dtype).element_size())

    @property
    def page_bytes(self) -> int:
        return self.page_tokens * self.token_bytes

    def empty_page(self) -> torch.Tensor:
        return torch.zeros((2, self.page_tokens, self.kv_heads,
                            self.head_dim), dtype=self.dtype)


class _TieredKV(KVCacheEngine):
    """Shared engine plumbing: the host-facing append/read protocol,
    preempt/restore through the disk tier, the preempted-sequence guard,
    release, and the uniform stats key set. Engines implement
    ``_append_tokens`` / ``_read`` / ``_drop_seq`` / ``_spill``."""

    def __init__(self, spec: KVSpec, clock: SimClock):
        self.spec = spec
        self.clock = clock
        self.seq_len: dict[int, int] = {}
        self._preempted: dict = {}
        self.stats: dict = {"preempts": 0, "restores": 0, "releases": 0,
                            "preempt_out_bytes": 0, "restore_in_bytes": 0,
                            # prefix-sharing counters — zero without a
                            # prefix cache; the stats key set stays the
                            # reference's
                            "prefix_hits": 0, "prefix_tokens_reused": 0,
                            "cow_copies": 0, "shared_pages": 0,
                            # async-tiering counters — zero without a
                            # transfer pipeline, same rule
                            "async_spills": 0, "prefetch_hits": 0,
                            "stall_ticks_saved": 0,
                            # fault-tolerance counters — zero while no
                            # injector exists, same rule
                            "transfer_retries": 0, "transfer_failures": 0,
                            "retried_faults": 0, "host_pages_lost": 0,
                            "shard_stalls": 0, "tiering_degraded": 0}
        # per-plane pool traffic: pool_d2h_bytes_<p> == pool_page_spills ×
        # plane_page_bytes(p) for every paged plane
        for plane in PLANE_STAT_NAMES:
            self.stats[f"pool_d2h_bytes_{plane}"] = 0
            self.stats[f"pool_h2d_bytes_{plane}"] = 0

    # hooks -----------------------------------------------------------------
    def _append_tokens(self, seq: int, toks: list) -> None:
        raise NotImplementedError

    def _read(self, seq: int, layer: int) -> torch.Tensor:
        raise NotImplementedError

    def _drop_seq(self, seq: int) -> None:
        raise NotImplementedError

    def _spill(self, seq: int) -> torch.Tensor:
        """Materialize ``(L, 2, T, K, D)`` for preemption WITHOUT the read
        path's side effects (no HBM LRU touches, DMA faults, or router
        reuse feedback) — preempting must not pollute what stays
        resident."""
        raise NotImplementedError

    # protocol --------------------------------------------------------------
    def _check_active(self, seq: int) -> None:
        if seq in self._preempted:
            raise RuntimeError(
                f"sequence {seq} is preempted to disk; restore() it first")

    def append(self, seq: int, kv_tokens) -> None:
        self._check_active(seq)
        kv_tokens = torch.as_tensor(kv_tokens)
        if kv_tokens.ndim == 4:            # (L, 2, K, D): one decoded token
            toks = [kv_tokens]
        elif kv_tokens.ndim == 5:          # (L, 2, T, K, D): prefill burst
            toks = list(kv_tokens.unbind(2))
        else:
            raise ValueError(
                f"kv_tokens must be (L, 2, K, D) or (L, 2, T, K, D); got "
                f"shape {tuple(kv_tokens.shape)}")
        if toks:
            self._append_tokens(seq, toks)

    def read(self, seq: int, layer: int) -> torch.Tensor:
        self._check_active(seq)
        return self._read(seq, layer)

    def preempt(self, seq: int) -> None:
        self._check_active(seq)
        blob = self._spill(seq)
        nbytes = _nbytes(blob)
        # sequential drain of the whole sequence out of the host tier and
        # onto the disk tier (one streamed copy, no random faults)
        self.clock.charge(HOST_LINK, "read", nbytes, random_access=False)
        self.clock.charge(SSD, "write", nbytes, random_access=False)
        self._drop_seq(seq)
        self.seq_len.pop(seq, None)
        self._preempted[seq] = blob
        self.stats["preempts"] += 1
        self.stats["preempt_out_bytes"] += nbytes

    def restore(self, seq: int) -> None:
        blob = self._preempted.pop(seq, None)
        if blob is None:
            raise RuntimeError(f"sequence {seq} is not preempted")
        nbytes = _nbytes(blob)
        self.clock.charge(SSD, "read", nbytes, random_access=False)
        self.stats["restores"] += 1
        self.stats["restore_in_bytes"] += nbytes
        toks = list(blob.unbind(2))
        if toks:
            # restore re-enters through the append path: one large batch —
            # under kvhybrid a long cold sequence lands on the page side
            self._append_tokens(seq, toks)

    def _on_release(self, seq: int) -> None:
        """Hook: per-sequence policy-state cleanup on release (adaptive
        routers forget their reuse histograms here). Runs on both release
        branches, active and preempted."""

    def release(self, seq: int) -> None:
        """Finished request: drop the sequence from every tier. A preempted
        sequence just drops its disk blob; an active one drops host/HBM
        state through the engine's ``_drop_seq``."""
        if self._preempted.pop(seq, None) is None:
            self._drop_seq(seq)
            self.seq_len.pop(seq, None)
        self.stats["releases"] += 1
        self._on_release(seq)


@register_kv_engine("paged")
class PagedKVCache(_TieredKV):
    """NVPages design over (layer, seq) KV pages.

    Two modes share the block table and the (seq → [phys]) indirection:

    * **host mode** (default): pages live in a host pool of CPU tensors,
      an HBM LRU of ``(layer, phys)`` pages models the device working set,
      appends pay the 2× redo + page host write, misses DMA whole pages
      up. The dense-mirror serving path appends to it.
    * **pooled mode** (:meth:`init_pool`, the mirror-free serving path):
      pages live in device-resident ``(L, P, T, *shape)`` planes. Decode
      and prefill appends are device-born: the model scatters them in
      place into the pool tensors (:meth:`pool_views` hands out the
      engine's own tensors) and :meth:`commit_step_planes` /
      :meth:`commit_prefill_planes` advance the accounting — HBM writes
      only, zero device→host traffic.
    """

    def __init__(self, spec: KVSpec, clock: SimClock, *,
                 hbm_budget_bytes: int, async_tiering: bool = False,
                 transfer_max_retries: int = 3,
                 transfer_backoff_s: float = 1e-4):
        super().__init__(spec, clock)
        self.pool: dict[tuple, torch.Tensor] = {}   # (layer, phys) → page
        self.block_table: dict[int, list[int]] = {}  # seq → [phys per logical]
        self.hbm_lru = LRUList()                     # (layer, phys) resident
        self.hbm_budget_bytes = hbm_budget_bytes
        self.hbm_capacity = max(hbm_budget_bytes // spec.page_bytes, 1)
        self.next_phys = 0
        self._pooled = False
        self._state_only = False       # a pool of state rows, no pages
        self.async_tiering = bool(async_tiering)
        self._pipeline = None          # TransferPipeline once pooled + async
        self._share_index = None       # prefix index (set_share_index)
        self._injector = None          # FaultInjector (set_fault_injector)
        self._xfer_retries = transfer_max_retries
        self._xfer_backoff = transfer_backoff_s
        self.stats.update({"hbm_hits": 0, "hbm_misses": 0, "dma_up_bytes": 0,
                           "host_writes": 0, "redo_bytes": 0})

    @classmethod
    def from_spec(cls, spec: EngineSpec, kvspec: KVSpec,
                  clock: SimClock) -> "PagedKVCache":
        return cls(kvspec, clock, hbm_budget_bytes=spec.kv_hbm_bytes,
                   async_tiering=spec.async_tiering,
                   transfer_max_retries=spec.transfer_max_retries,
                   transfer_backoff_s=spec.transfer_backoff_s)

    # ------------------------------------------------------ device page pool
    def supports_pool(self) -> bool:
        return True

    @property
    def pooled(self) -> bool:
        return self._pooled

    def _require_pool(self) -> None:
        if not self._pooled:
            raise RuntimeError(
                "this method works on the device page pool; call init_pool() "
                "first (host mode has no pool)")

    def init_pool(self, dtype=None, pages: Optional[int] = None,
                  device="cuda") -> None:
        """Allocate the device page pool on ``device``: one zeroed
        ``(L, P, T, *shape)`` tensor per descriptor plane, ``P`` sized
        from the HBM budget unless ``pages`` overrides it. A state-only
        descriptor (SSM) allocates no pages: its per-sequence state rows
        live beside the block tables, as many as the budget holds."""
        if self._pooled:
            raise RuntimeError("init_pool() called twice")
        if self.seq_len or self.pool or self._preempted:
            raise RuntimeError("init_pool() must run before any append")
        spec = self.spec
        desc = spec.descriptor()
        if dtype is not None:
            desc = desc.with_kv_dtype(dtype)
        if desc.page_tokens != spec.page_tokens:
            raise ValueError(
                f"descriptor page_tokens={desc.page_tokens} disagrees with "
                f"KVSpec page_tokens={spec.page_tokens}")
        self.desc = desc
        self.device = torch.device(device)
        self._plane_names = tuple(p.name for p in desc.paged_planes)
        self._state_only = not desc.has_pages
        kv_planes = [p for p in desc.paged_planes if p.kind == "kv"]
        self.pool_dtype = (kv_planes[0].torch_dtype if kv_planes
                           else torch.float32)
        # one physical page spans every layer and every plane (the block
        # table is shared by the whole stack), so a page group costs L
        # per-layer pages of HBM summed across the descriptor's planes
        self._group_bytes = desc.page_group_bytes
        self.dev_planes: dict = {}
        if desc.has_pages:
            self.pool_pages = (pages if pages is not None else
                               max(self.hbm_budget_bytes // self._group_bytes,
                                   1))
            for p in desc.paged_planes:
                shape = ((spec.num_layers, self.pool_pages, spec.page_tokens)
                         + tuple(p.shape))
                self.dev_planes[p.name] = torch.zeros(
                    shape, dtype=p.torch_dtype, device=self.device)
        else:
            # state-only layout (SSM): no pages; per-seq state rows ride
            # beside the (empty) block tables, spilled and restored whole
            self.pool_pages = 0
            self._state_capacity = max(
                self.hbm_budget_bytes // max(desc.seq_state_bytes, 1), 1)
        # seq → plane → (L, *shape) device tensor
        self.seq_state: dict[int, dict] = {}
        self.free_pages: list[int] = list(range(self.pool_pages - 1, -1, -1))
        self.pool_lru = LRUList()                    # resident phys pages
        # refcounted page users: phys → {seq: logical}. A page may appear in
        # several sequences' block tables at once (prefix sharing); it is
        # freed only when its user dict empties AND no index pin remains.
        self.page_users: dict[int, dict[int, int]] = {}
        self.trie_refs: set[int] = set()             # index-pinned pages
        # spilled pages: (seq, logical) → {plane → (L, T, *shape)} on the host
        self.host_pages: dict[tuple[int, int], dict] = {}
        self._pooled = True
        # async tiering: spills/faults drain through a background pipeline;
        # the hot/cold victim model runs in BOTH modes so spill decisions
        # (and therefore tokens) are identical sync vs async. Lazy import:
        # the serving package imports this module through its engine.
        from repro_torch.serving.tiering import PageHeat, TransferPipeline
        if self.async_tiering:
            self._pipeline = TransferPipeline(
                self.clock, stats=self.stats, injector=self._injector,
                max_retries=self._xfer_retries,
                backoff_s=self._xfer_backoff)
        self._heat = PageHeat()
        self._alloc_seq = 0            # allocation counter (logical time)
        self._fault_mark: dict[int, int] = {}   # phys → _alloc_seq at fault
        self.stats.update({"pool_appends": 0, "pool_hits": 0,
                           "pool_faults": 0, "pool_page_spills": 0,
                           "pool_d2h_bytes": 0, "pool_h2d_bytes": 0})

    def pool_views(self):
        """Device pool planes in descriptor order — the engine's OWN
        tensors, which the model's steps scatter into in place."""
        if not self._pooled:
            return super().pool_views()      # the loud "no pool" error
        return tuple(self.dev_planes[n] for n in self._plane_names)

    def _token_group_bytes(self) -> int:
        """One pooled token across all layers and planes."""
        return self.desc.token_group_bytes

    def _page_planes_host(self, phys: int) -> dict:
        """Copy device page ``phys`` to the host, one ``(L, T, *shape)``
        tensor per plane (a copy even when the pool itself is on the CPU:
        the slot is about to be reused)."""
        return {n: self.dev_planes[n][:, phys].to("cpu", copy=True)
                for n in self._plane_names}

    def _count_plane_bytes(self, counter: str, page: dict) -> None:
        """Charge a page/blob's bytes to the per-plane traffic counters."""
        for name, arr in page.items():
            self.stats[f"{counter}_{name}"] += _nbytes(arr)

    def _touch_page(self, phys: int) -> None:
        """One page access: LRU recency + the hot/cold model's EMA."""
        self.pool_lru.touch(phys)
        self._heat.touch(phys)

    def _recently_faulted(self, phys: int) -> bool:
        """Was ``phys`` faulted within the last pool-size allocations?
        Such pages spill only as a last resort (thrash guard). Allocation
        count, not wall time, so sync/async rank identically."""
        return (self._alloc_seq - self._fault_mark.get(phys, -self.pool_pages)
                <= self.pool_pages)

    def _spill_lru_page(self, pinned: set) -> int:
        """Evict one spillable resident page to the host tier (page-granular
        spill); returns the freed physical index.

        Only a page with exactly ONE live user — and that user outside the
        pinned batch — can spill coherently; pages aliased by several
        sequences never spill. A single-user page the prefix index also
        pins is forgotten from the index first (a pin with no index behind
        it is dropped). Eligible candidates rank by
        ``(recently_faulted, hotness, LRU rank)``: the coldest page by the
        :class:`~repro_torch.serving.tiering.PageHeat` re-reference model
        first, LRU order breaking ties, just-faulted pages last."""
        best = None
        for rank, phys in enumerate(self.pool_lru.lru_order()):
            users = self.page_users.get(phys)
            if not users or len(users) > 1:
                continue               # index-only (reclaimed, not spilled)
                                       # or shared between live sequences
            (seq, logical), = users.items()
            if seq in pinned:
                continue
            key = (self._recently_faulted(phys), self._heat.hotness(phys),
                   rank)
            if best is None or key < best[0]:
                best = (key, phys, seq, logical)
        if best is None:
            raise RuntimeError(
                "paged pool exhausted: every resident page is pinned, "
                "shared, or index-held — the HBM budget is too small for "
                "the running batch")
        _, phys, seq, logical = best
        if phys in self.trie_refs:
            if self._share_index is not None:
                self._share_index.forget_phys(phys)
            else:
                self.trie_refs.discard(phys)
        page = self._page_planes_host(phys)
        nbytes = sum(_nbytes(a) for a in page.values())
        self.host_pages[(seq, logical)] = page
        self.block_table[seq][logical] = -1
        self.page_users.pop(phys)
        self.pool_lru.remove(phys)
        if self._pipeline is not None and not self._pipeline.degraded:
            self._pipeline.submit(self._pipeline.D2H, ("d2h", seq, logical),
                                  HOST_LINK, "write", nbytes)
            self.stats["async_spills"] += 1
            self.stats["stall_ticks_saved"] += 1   # sync stalls right here
        else:
            self.clock.charge(HOST_LINK, "write", nbytes,
                              random_access=True)          # D2H page out
        self.stats["pool_page_spills"] += 1
        self.stats["pool_d2h_bytes"] += nbytes
        self._count_plane_bytes("pool_d2h_bytes", page)
        return phys

    def _alloc_page(self, pinned: set) -> int:
        self._alloc_seq += 1
        if self.free_pages:
            return self.free_pages.pop()
        # reclaim before spilling: an idle index-held page (no live user)
        # frees without any D2H traffic — dropping cached prefix KV is
        # cheaper than spilling a live sequence's page
        if self._share_index is not None:
            if self._share_index.reclaim_one() is not None:
                return self.free_pages.pop()
        else:
            # pins without an index object free an idle one directly, so
            # the headroom the pressure surface counted exists here
            idle = next((p for p in sorted(self.trie_refs)
                         if not self.page_users.get(p)), None)
            if idle is not None:
                self.trie_refs.discard(idle)
                self.page_users.pop(idle, None)
                if idle in self.pool_lru:
                    self.pool_lru.remove(idle)
                return idle
        return self._spill_lru_page(pinned)

    def _extend_table(self, seq: int, pinned: set) -> None:
        table = self.block_table.setdefault(seq, [])
        phys = self._alloc_page(pinned)
        self.page_users[phys] = {seq: len(table)}
        table.append(phys)
        self._heat.assign(phys)
        self._touch_page(phys)

    def _fault_page(self, seq: int, logical: int, pinned: set) -> None:
        """Demand fault: bring spilled page ``(seq, logical)`` back from
        the host into a freshly allocated pool slot (H2D one page group),
        written in place into the device planes. A page the fault injector
        declares lost raises :class:`LostPageError` before any allocation,
        so there is nothing to unwind: the scheduler sheds the row."""
        if self._injector is not None \
                and self._injector.page_lost(seq, logical):
            from repro_torch.serving.faults import LostPageError
            if self._pipeline is not None:
                self._pipeline.cancel(("d2h", seq, logical), reclaim=True)
                self._pipeline.cancel(("h2d", seq, logical), reclaim=True)
            self.host_pages.pop((seq, logical), None)
            self.stats["host_pages_lost"] += 1
            raise LostPageError(seq, logical)
        phys = self._alloc_page(pinned)
        prefetched = False
        retried = False
        pipe = self._pipeline
        use_async = pipe is not None and not pipe.degraded
        if pipe is not None:
            # coherence: the H2D reads the host staging copy, so it chains
            # after the page's own D2H finish when that is still in flight
            d2h_key = ("d2h", seq, logical)
            after = pipe.finish_of(d2h_key) or 0.0
            h2d_key = ("h2d", seq, logical)
            prefetched = pipe.finish_of(h2d_key) is not None
            if use_async:
                pipe.cancel(d2h_key)      # the h2d chains after= instead
                if not prefetched:
                    pipe.submit(pipe.H2D, h2d_key, HOST_LINK,
                                "read", self._group_bytes, after=after)
                if pipe.barrier(h2d_key) == 0.0:
                    self.stats["stall_ticks_saved"] += 1
                retried = pipe.took_retries(h2d_key)
            else:
                pipe.barrier(d2h_key)
                pipe.barrier(h2d_key)
        page = self.host_pages.pop((seq, logical))   # plane → (L, T, *shape)
        nbytes = sum(_nbytes(a) for a in page.values())
        for name in self._plane_names:
            plane = self.dev_planes[name]
            plane[:, phys] = page[name].to(plane.device, plane.dtype)
        self.block_table[seq][logical] = phys
        self.page_users[phys] = {seq: logical}
        self._heat.assign(phys)
        self._touch_page(phys)
        self._fault_mark[phys] = self._alloc_seq
        if pipe is None or (not use_async and not prefetched):
            self.clock.charge(HOST_LINK, "read", nbytes,
                              random_access=True)        # H2D fault-in
        if prefetched:
            self.stats["prefetch_hits"] += 1
        elif retried:
            self.stats["retried_faults"] += 1
        else:
            self.stats["pool_faults"] += 1
        self.stats["pool_h2d_bytes"] += nbytes
        self._count_plane_bytes("pool_h2d_bytes", page)

    def _ensure_seq_resident(self, seq: int, pinned: set) -> None:
        faulted = []
        for logical, phys in enumerate(self.block_table.get(seq, [])):
            if phys < 0:
                self._fault_page(seq, logical, pinned)
                faulted.append(self.block_table[seq][logical])
            else:
                self._touch_page(phys)
                self.stats["pool_hits"] += 1
        # the whole sequence was accessed at once: re-touch the faulted
        # burst so the pages that just paid an H2D are not the coldest
        for phys in faulted:
            self.pool_lru.touch(phys)

    def prepare_step(self, seqs: Sequence[int], n_tokens: Sequence[int],
                     max_pages: int):
        """Multi-token step preparation (fused mixed-batch ticks): every
        batch sequence's pages are pinned — a later allocation must never
        spill a page the kernel is about to read — and each sequence gets
        pages covering its whole chunk. Returns ``(table (B, max_pages)
        int32, lengths (B,) int32)`` as host numpy arrays; dead table
        entries are 0."""
        self._require_pool()
        if self._state_only:
            raise RuntimeError(
                "state-only descriptor has no pages; drive steps through "
                "state_views()/commit_state()")
        pinned = set(seqs)
        T = self.spec.page_tokens
        for seq, n in zip(seqs, n_tokens):
            self._check_active(seq)
            self._ensure_seq_resident(seq, pinned)
            self._maybe_cow_boundary(seq, pinned)
            table = self.block_table.setdefault(seq, [])
            end = self.seq_len.get(seq, 0) + max(int(n), 1)
            for _ in range(-(-end // T) - len(table)):
                self._extend_table(seq, pinned)
        tbl = np.zeros((len(seqs), max_pages), np.int32)
        lens = np.zeros(len(seqs), np.int32)
        for i, seq in enumerate(seqs):
            row = self.block_table.get(seq, [])
            if len(row) > max_pages:
                raise ValueError(
                    f"sequence {seq} spans {len(row)} pages > max_pages="
                    f"{max_pages}")
            tbl[i, :len(row)] = row
            lens[i] = self.seq_len.get(seq, 0)
        return tbl, lens

    def commit_step(self, pool_k, pool_v, seqs: Sequence[int],
                    n_tokens: Sequence[int],
                    prepared: Optional[Sequence[int]] = None) -> None:
        """Dense ``(k, v)`` special case of :meth:`commit_step_planes`."""
        return self.commit_step_planes((pool_k, pool_v), seqs, n_tokens,
                                       prepared=prepared)

    def commit_step_planes(self, planes, seqs: Sequence[int],
                           n_tokens: Sequence[int],
                           prepared: Optional[Sequence[int]] = None) -> None:
        """Commit ``n_tokens[i]`` tokens per sequence. ``planes`` are the
        pool planes in descriptor order — on the serving path the very
        tensors :meth:`pool_views` handed out, which the step updated in
        place; storing them is then a no-op. With a partial commit
        (``n_tokens[i] < prepared[i]``) ``seq_len`` advances by the
        accepted count only and pages allocated solely for the tail go
        back to the free list."""
        self._require_pool()
        if len(planes) != len(self._plane_names):
            raise ValueError(
                f"expected {len(self._plane_names)} pool planes "
                f"{self._plane_names}, got {len(planes)}")
        for name, arr in zip(self._plane_names, planes):
            self.dev_planes[name] = arr
        per_tok = self._token_group_bytes()
        T = self.spec.page_tokens
        for i, (seq, n) in enumerate(zip(seqs, n_tokens)):
            n = int(n)
            prep = n if prepared is None else int(prepared[i])
            pos = self.seq_len.get(seq, 0)
            self.seq_len[seq] = pos + n
            # a prepared page can be spilled mid-tick by an out-of-batch
            # allocation once the prepare pin is released — its -1 marker
            # must never enter the LRU/heat maps
            for logical in range(pos // T, -(-(pos + n) // T)):
                phys = self.block_table[seq][logical]
                if phys >= 0:
                    self._touch_page(phys)
            self.clock.charge(HBM, "write", max(prep, n) * per_tok)
            self.stats["pool_appends"] += n
            if prep > n:
                self._rewind_step_pages(seq)

    def _rewind_step_pages(self, seq: int) -> None:
        """Rollback: drop trailing block-table pages past the committed
        length. Such pages are this step's fresh allocations — sole-user,
        unpinned (``_extend_table`` never hands out a shared or index-held
        page) — so they return straight to the free list; a trailing
        page spilled between prepare and commit drops its dead host copy
        (cancelling its in-flight transfers). The D2H byte counters are
        not rewound: the spill moved real bytes."""
        T = self.spec.page_tokens
        keep = max(-(-self.seq_len.get(seq, 0) // T), 0)
        table = self.block_table.get(seq, [])
        while len(table) > keep:
            phys = table[-1]
            if phys < 0:
                table.pop()
                logical = len(table)
                self.host_pages.pop((seq, logical), None)
                if self._pipeline is not None:
                    self._pipeline.cancel(("d2h", seq, logical),
                                          reclaim=True)
                    self._pipeline.cancel(("h2d", seq, logical),
                                          reclaim=True)
                continue
            users = self.page_users.get(phys, {})
            if phys in self.trie_refs or users.keys() - {seq}:
                break
            table.pop()
            users.pop(seq, None)
            if not users:
                self.page_users.pop(phys, None)
                self.pool_lru.remove(phys)
                self.free_pages.append(phys)

    def alloc_prefill(self, seq: int, n_tokens: int):
        self._require_pool()
        pinned = {seq}
        self._check_active(seq)
        self._ensure_seq_resident(seq, pinned)
        if n_tokens > 0:
            self._maybe_cow_boundary(seq, pinned)
        table = self.block_table.setdefault(seq, [])
        end = self.seq_len.get(seq, 0) + n_tokens
        need = -(-end // self.spec.page_tokens) - len(table)
        for _ in range(max(need, 0)):
            self._extend_table(seq, pinned)
        return np.asarray(table, np.int32)

    def commit_prefill(self, pool_k, pool_v, seq: int,
                       n_tokens: int) -> None:
        """Dense ``(k, v)`` special case of :meth:`commit_prefill_planes`."""
        return self.commit_prefill_planes((pool_k, pool_v), seq, n_tokens)

    def commit_prefill_planes(self, planes, seq: int, n_tokens: int) -> None:
        self._require_pool()
        if len(planes) != len(self._plane_names):
            raise ValueError(
                f"expected {len(self._plane_names)} pool planes "
                f"{self._plane_names}, got {len(planes)}")
        for name, arr in zip(self._plane_names, planes):
            self.dev_planes[name] = arr
        self.seq_len[seq] = self.seq_len.get(seq, 0) + n_tokens
        for phys in self.block_table.get(seq, []):
            if phys >= 0:
                self._touch_page(phys)
        self.clock.charge(HBM, "write", n_tokens * self._token_group_bytes())
        self.stats["pool_appends"] += n_tokens

    def _idle_index_pages(self) -> int:
        """Index-pinned pages with no live user that allocation can actually
        free on demand. With an index registered, an idle pin reclaims
        through ``reclaim_one`` only while its trie node is unreferenced,
        so the count caps at the index's own reclaimable total; with no
        index object, idle pins free directly in ``_alloc_page``."""
        idle = sum(1 for p in self.trie_refs if not self.page_users.get(p))
        if idle == 0 or self._share_index is None:
            return idle
        cap = getattr(self._share_index, "reclaimable_pages", None)
        return idle if cap is None else min(idle, cap())

    def can_admit_tokens(self, n_tokens: int) -> bool:
        if not self._pooled:
            return True
        if self._state_only:
            # state rows are fixed-size: admission is a row-count check
            return len(self.seq_state) < self._state_capacity
        pages_needed = -(-n_tokens // self.spec.page_tokens)
        return (pages_needed + self._reserve_pages()
                <= len(self.free_pages) + self._idle_index_pages())

    def can_place_step(self, seqs: Sequence[int],
                       n_tokens: Sequence[int]) -> bool:
        """Conservative placement check for one fused step: every page the
        batch will hold afterwards (chunk growth + faulting back any
        spilled page of a batch sequence, plus a possible boundary COW per
        row) must be coverable by free pages plus pages spillable from
        sequences OUTSIDE the batch — because ``prepare_step`` pins the
        whole batch while allocating. Shared pages (several live users)
        never spill, so they don't count; idle index-held pages reclaim
        for free, so they do."""
        if not self._pooled or self._state_only:
            return True
        T = self.spec.page_tokens
        batch = set(seqs)
        needed = 0
        for seq, n in zip(seqs, n_tokens):
            table = self.block_table.get(seq, [])
            resident = sum(1 for p in table if p >= 0)
            target = -(-(self.seq_len.get(seq, 0) + max(int(n), 1)) // T)
            needed += max(target, len(table)) - resident
            pos = self.seq_len.get(seq, 0)
            if pos % T:
                logical = pos // T
                if logical < len(table) and \
                        len(self.page_users.get(table[logical], ())) > 1:
                    needed += 1        # boundary copy-on-write page
        spillable = sum(
            1 for phys, users in self.page_users.items()
            if len(users) == 1 and next(iter(users)) not in batch)
        return needed <= (len(self.free_pages) + self._idle_index_pages()
                          + spillable)

    def _reserve_pages(self) -> int:
        """Pages the next decode step will claim: one per active sequence
        whose next token starts a fresh page."""
        if self._state_only:
            return 0
        T = self.spec.page_tokens
        return sum(1 for seq, n in self.seq_len.items()
                   if seq not in self._preempted
                   and n >= T * len(self.block_table.get(seq, ())))

    # ------------------------------------------------- async tier transfers
    def prefetch(self, seqs: Sequence[int],
                 n_tokens: Optional[Sequence[int]] = None) -> int:
        """Schedule background H2D fault-ins for every spilled page of next
        tick's planned batch. Timing-only: no allocation and no data
        movement, so placement stays identical to a synchronous run."""
        if not self._pooled or self._pipeline is None \
                or self._pipeline.degraded:
            return 0
        n = 0
        for seq in seqs:
            if seq in self._preempted:
                continue
            for logical, phys in enumerate(self.block_table.get(seq, ())):
                if phys >= 0:
                    continue
                key = ("h2d", seq, logical)
                if self._pipeline.finish_of(key) is not None:
                    continue           # already in flight from a prior tick
                after = self._pipeline.finish_of(("d2h", seq, logical)) or 0.0
                self._pipeline.submit(self._pipeline.H2D, key, HOST_LINK,
                                      "read", self._group_bytes, after=after)
                n += 1
        return n

    def flush_transfers(self) -> None:
        if self._pooled and self._pipeline is not None:
            self._pipeline.flush()

    # ------------------------------------------------- faults & recovery
    def set_fault_injector(self, injector) -> None:
        """Attach the serving tier's deterministic injector. Transfer
        fail/delay decisions live in the pipeline; the spilled host-page
        loss check lives in ``_fault_page``. Placement never consults the
        injector, so transfer faults stay timing-only."""
        self._injector = injector
        if self._pipeline is not None:
            self._pipeline.injector = injector

    def abort_step(self, seqs: Sequence[int]) -> None:
        """Roll back a prepared-but-uncommitted step: ``seq_len`` never
        advanced, so rewinding each row to its committed length returns
        exactly this tick's fresh allocations to the free list."""
        if not self._pooled or self._state_only:
            return
        for seq in seqs:
            if seq in self.block_table:
                self._rewind_step_pages(seq)

    def stall_transfers(self, direction: int, seconds: float) -> None:
        if self._pooled and self._pipeline is not None:
            self._pipeline.stall_channel(direction, seconds)

    # ------------------------------------------------------- prefix sharing
    def supports_sharing(self) -> bool:
        return self._pooled and not self._state_only

    def set_share_index(self, index) -> None:
        self._require_pool()
        self._share_index = index

    def page_refs(self, phys: int) -> int:
        if not self._pooled:
            return 0
        return (len(self.page_users.get(phys, ()))
                + (1 if phys in self.trie_refs else 0))

    def adopt_pages(self, seq: int, pages: Sequence[int],
                    covered_tokens: int) -> None:
        """Splice-on-admit: alias ``seq``'s block table onto shared pool
        pages covering its first ``covered_tokens`` prompt tokens. Pure
        metadata — page refcounts go up, zero KV moves, zero compute."""
        self._require_pool()
        self._check_active(seq)
        if self.block_table.get(seq) or self.seq_len.get(seq):
            raise RuntimeError(
                f"sequence {seq} already holds pages; prefix splice is "
                f"admission-only")
        if len(pages) != -(-covered_tokens // self.spec.page_tokens):
            raise ValueError(
                f"{len(pages)} pages cannot cover {covered_tokens} tokens "
                f"at {self.spec.page_tokens} tokens/page")
        table = self.block_table[seq] = []
        for logical, phys in enumerate(pages):
            users = self.page_users.setdefault(phys, {})
            if len(users) == 1:
                self.stats["shared_pages"] += 1   # gained a 2nd live user
            users[seq] = logical
            table.append(phys)
            self._touch_page(phys)
        self.seq_len[seq] = covered_tokens
        self.stats["prefix_hits"] += 1
        self.stats["prefix_tokens_reused"] += covered_tokens

    def pin_page(self, phys: int) -> None:
        if phys in self.trie_refs:
            return
        if self.page_users.get(phys):
            self.stats["shared_pages"] += 1       # index + live user(s)
        self.trie_refs.add(phys)

    def unpin_page(self, phys: int) -> None:
        self.trie_refs.discard(phys)
        if not self.page_users.get(phys):
            # the index was the last referent: free the page
            self.page_users.pop(phys, None)
            if phys in self.pool_lru:
                self.pool_lru.remove(phys)
                self.free_pages.append(phys)

    def _maybe_cow_boundary(self, seq: int, pinned: set) -> None:
        """Copy-on-write before a write lands mid-page: if the page holding
        ``seq``'s next slot is aliased by OTHER live sequences, the writer
        gets a private copy first and readers keep the original. A page
        whose only other referent is the prefix index needs no copy:
        splicers trust only the first ``covered`` slots (the kernel masks
        beyond each row's length), and those slots are never rewritten with
        different values."""
        T = self.spec.page_tokens
        pos = self.seq_len.get(seq, 0)
        if pos % T == 0:
            return                     # next write starts a fresh page
        logical = pos // T
        table = self.block_table.get(seq, ())
        if logical >= len(table):
            return
        phys = table[logical]
        if phys < 0 or len(self.page_users.get(phys, ())) <= 1:
            return
        self._cow_page(seq, logical, pinned)

    def _cow_page(self, seq: int, logical: int, pinned: set) -> None:
        """Duplicate ``seq``'s view of a shared page into a fresh physical
        page (one on-device copy over every paged plane) and retarget its
        block table; every other referent — sequences and the prefix index
        — keeps the original."""
        # lazy import: the serving package imports this module through its
        # engine
        from repro_torch.serving.batching import copy_pool_page_planes
        phys = self.block_table[seq][logical]
        new = self._alloc_page(set(pinned) | {seq})
        copy_pool_page_planes(
            tuple(self.dev_planes[n] for n in self._plane_names), phys, new)
        self.page_users[phys].pop(seq, None)
        self.page_users[new] = {seq: logical}
        self.block_table[seq][logical] = new
        self._heat.assign(new)
        self._touch_page(new)
        self.clock.charge(HBM, "read", self._group_bytes)
        self.clock.charge(HBM, "write", self._group_bytes)
        self.stats["cow_copies"] += 1
        if self._share_index is not None:
            self._share_index.on_cow(seq, phys)

    # ------------------------------------------------------ per-seq state rows
    # SSM configs pool ZERO paged planes: their cache is a fixed-size state
    # row per sequence (descriptor seq_planes) that rides alongside the
    # block tables — committed with the row each step, spilled/preempted/
    # restored whole, and rolled back by committing an earlier slot's state.
    def _require_state(self, what: str) -> None:
        if not self._pooled or not self.desc.has_state:
            raise RuntimeError(f"{what}() requires a pooled engine with a "
                               f"state-bearing descriptor")

    def state_views(self, seqs: Sequence[int]):
        """Batched state rows for one step: one ``(L, B, *shape)`` device
        tensor per seq plane in descriptor order (a copy: the step may do
        as it likes with it). Sequences without committed state yet (fresh
        admissions) read zero rows."""
        self._require_state("state_views")
        out = []
        for p in self.desc.seq_planes:
            zero = None
            rows = []
            for seq in seqs:
                arr = self.seq_state.get(seq, {}).get(p.name)
                if arr is None:
                    if zero is None:
                        zero = torch.zeros(
                            (self.spec.num_layers,) + tuple(p.shape),
                            dtype=p.torch_dtype, device=self.device)
                    arr = zero
                rows.append(arr)
            out.append(torch.stack(rows, dim=1))
        return tuple(out)

    def commit_state(self, seqs: Sequence[int], n_tokens: Sequence[int],
                     states) -> None:
        """Commit one step's updated state rows. ``states``: one
        ``(L, B, *shape)`` tensor per seq plane (descriptor order); row
        ``i`` (copied out) becomes ``seqs[i]``'s new state and ``seq_len``
        advances by ``n_tokens[i]``. Rows with ``n_tokens[i] == 0`` (batch
        padding, fully-rejected speculative rows) commit NOTHING — their
        stored state is untouched, the state-row form of the paged rewind
        rule."""
        self._require_state("commit_state")
        live = 0
        for i, (seq, n) in enumerate(zip(seqs, n_tokens)):
            n = int(n)
            if n <= 0:
                continue
            self._check_active(seq)
            live += 1
            row = self.seq_state.setdefault(seq, {})
            for p, arr in zip(self.desc.seq_planes, states):
                row[p.name] = arr[:, i].to(p.torch_dtype, copy=True)
            self.seq_len[seq] = self.seq_len.get(seq, 0) + n
            self.stats["pool_appends"] += n
        self.clock.charge(HBM, "write", live * self.desc.seq_state_bytes)

    def _spill_state_planes(self, seq: int) -> dict:
        """Preemption blobs for a state-only sequence: the device state
        rows come down over the link (D2H), one host tensor per seq
        plane."""
        blobs = {}
        for p in self.desc.seq_planes:
            arr = self.seq_state.get(seq, {}).get(p.name)
            blobs[p.name] = (
                torch.zeros((self.spec.num_layers,) + tuple(p.shape),
                            dtype=p.torch_dtype) if arr is None
                else arr.to("cpu", copy=True))
        nbytes = sum(_nbytes(a) for a in blobs.values())
        self.clock.charge(HOST_LINK, "write", nbytes, random_access=False)
        self.stats["pool_d2h_bytes"] += nbytes
        self._count_plane_bytes("pool_d2h_bytes", blobs)
        return blobs

    def _restore_state_planes(self, seq: int, length: int,
                              blobs: dict) -> None:
        self.seq_state[seq] = {n: a.to(self.device, copy=True)
                               for n, a in blobs.items()}
        nbytes = sum(_nbytes(a) for a in blobs.values())
        self.clock.charge(HOST_LINK, "read", nbytes, random_access=False)
        self.clock.charge(HBM, "write", nbytes)
        self.stats["pool_h2d_bytes"] += nbytes
        self._count_plane_bytes("pool_h2d_bytes", blobs)
        self.seq_len[seq] = length

    # --------------------------------------------- pooled preempt / restore
    def preempt(self, seq: int) -> None:
        """Pooled preemption spills PLANE blobs (one token-exact host
        tensor per paged plane, or the state rows) rather than host mode's
        dense ``(L, 2, T, K, D)`` blob: the layout leaves the pool the
        same way it lives in it."""
        if not self._pooled:
            return super().preempt(seq)
        self._check_active(seq)
        length = self.seq_len.get(seq, 0)
        blobs = (self._spill_state_planes(seq) if self._state_only
                 else self._spill_pooled_planes(seq))
        nbytes = sum(_nbytes(a) for a in blobs.values())
        # sequential drain of the whole sequence out of the host tier and
        # onto the disk tier (one streamed copy, no random faults)
        self.clock.charge(HOST_LINK, "read", nbytes, random_access=False)
        self.clock.charge(SSD, "write", nbytes, random_access=False)
        self._drop_seq(seq)
        self.seq_len.pop(seq, None)
        self._preempted[seq] = (length, blobs)
        self.stats["preempts"] += 1
        self.stats["preempt_out_bytes"] += nbytes

    def restore(self, seq: int) -> None:
        if not self._pooled:
            return super().restore(seq)
        item = self._preempted.pop(seq, None)
        if item is None:
            raise RuntimeError(f"sequence {seq} is not preempted")
        length, blobs = item
        nbytes = sum(_nbytes(a) for a in blobs.values())
        self.clock.charge(SSD, "read", nbytes, random_access=False)
        self.stats["restores"] += 1
        self.stats["restore_in_bytes"] += nbytes
        if self._state_only:
            self._restore_state_planes(seq, length, blobs)
        else:
            self._restore_pooled_planes(seq, length, blobs)

    def _restore_pooled_planes(self, seq: int, length: int,
                               blobs: dict) -> None:
        """Scatter a preempted sequence's plane blobs into fresh pool
        pages, in place: disk → host (charged by :meth:`restore`) → device
        (PCIe upload + HBM write). Pages come from the same allocator as
        any append, so a tight pool may spill other sequences."""
        spec = self.spec
        pinned = {seq}
        table = self.block_table.setdefault(seq, [])
        npages = -(-length // spec.page_tokens)
        for _ in range(npages - len(table)):
            self._extend_table(seq, pinned)
        for logical in range(npages):
            lo = logical * spec.page_tokens
            hi = min(lo + spec.page_tokens, length)
            phys = table[logical]
            for name in self._plane_names:
                plane = self.dev_planes[name]
                plane[:, phys, :hi - lo] = blobs[name][:, lo:hi].to(
                    plane.device, plane.dtype)
            self._touch_page(phys)
        nbytes = sum(_nbytes(a) for a in blobs.values())
        self.clock.charge(HOST_LINK, "read", nbytes, random_access=False)
        self.clock.charge(HBM, "write", nbytes)
        self.stats["pool_h2d_bytes"] += nbytes
        self._count_plane_bytes("pool_h2d_bytes", blobs)
        self.stats["pool_appends"] += length
        self.seq_len[seq] = length

    # pooled data paths ------------------------------------------------------
    def _append_tokens_pooled(self, seq: int, toks: list) -> None:
        """Host-facing append in pooled mode (the sequential reference's
        mirror): scatter ``(L, 2, K, D)`` tokens into the device pool in
        place. Models device-born tokens (HBM write only). Dense
        ``(k, v)`` only."""
        if self.desc.kernel != "dense":
            raise NotImplementedError(
                f"host-facing appends are dense-only; {self.desc.family!r} "
                f"pools are fed on device via commit_step_planes/"
                f"commit_prefill_planes")
        spec = self.spec
        pinned = {seq}
        self._ensure_seq_resident(seq, pinned)
        if toks:
            self._maybe_cow_boundary(seq, pinned)
        table = self.block_table.setdefault(seq, [])
        start = self.seq_len.get(seq, 0)
        end = start + len(toks)
        for _ in range(-(-end // spec.page_tokens) - len(table)):
            self._extend_table(seq, pinned)
        arr = torch.stack(toks)                   # (n, L, 2, K, D)
        for logical in range(start // spec.page_tokens,
                             -(-end // spec.page_tokens)):
            lo = max(start, logical * spec.page_tokens)
            hi = min(end, (logical + 1) * spec.page_tokens)
            sl = slice(lo - logical * spec.page_tokens,
                       hi - logical * spec.page_tokens)
            chunk = arr[lo - start:hi - start]    # (m, L, 2, K, D)
            phys = table[logical]
            for j, name in enumerate(("k", "v")):
                plane = self.dev_planes[name]
                plane[:, phys, sl] = chunk[:, :, j].transpose(0, 1).to(
                    plane.device, self.pool_dtype)
            self._touch_page(phys)
        nbytes = len(toks) * self._token_group_bytes()
        self.clock.charge(HBM, "write", nbytes)
        self.stats["pool_appends"] += len(toks)
        self.seq_len[seq] = end

    def _read_pooled(self, seq: int, layer: int) -> torch.Tensor:
        """Materialize ``(2, T, K, D)`` of ``layer`` on the host in the
        KVSpec dtype (dense pools only)."""
        spec = self.spec
        if self.desc.kernel != "dense":
            raise NotImplementedError(
                f"host-facing reads are dense-only; {self.desc.family!r} "
                f"pools are consumed on device through pool_views()")
        self._ensure_seq_resident(seq, {seq})
        T = self.seq_len.get(seq, 0)
        out = torch.zeros((2, T, spec.kv_heads, spec.head_dim),
                          dtype=spec.dtype)
        dev_k, dev_v = self.dev_planes["k"], self.dev_planes["v"]
        for logical, phys in enumerate(self.block_table.get(seq, [])):
            lo = logical * spec.page_tokens
            hi = min(lo + spec.page_tokens, T)
            if lo >= T:
                break
            out[0, lo:hi] = dev_k[layer, phys, :hi - lo].to("cpu", spec.dtype)
            out[1, lo:hi] = dev_v[layer, phys, :hi - lo].to("cpu", spec.dtype)
            self._touch_page(phys)
            self.clock.charge(HBM, "read", (hi - lo) * spec.token_bytes)
        return out

    def _spill_pooled_planes(self, seq: int) -> dict:
        """Whole-sequence preemption blobs — one token-exact
        ``(L, T, *shape)`` host tensor per paged plane — gathered page by
        page: resident pages pay a D2H transfer each, already-spilled pages
        are host-side copies (no device traffic)."""
        spec = self.spec
        T = self.seq_len.get(seq, 0)
        blobs = {p.name: torch.zeros((spec.num_layers, T) + tuple(p.shape),
                                     dtype=p.torch_dtype)
                 for p in self.desc.paged_planes}
        for logical, phys in enumerate(self.block_table.get(seq, [])):
            lo = logical * spec.page_tokens
            hi = min(lo + spec.page_tokens, T)
            if lo >= T:
                break
            if phys < 0:
                if self._pipeline is not None:
                    # coherence barrier: never read an in-flight page
                    self._pipeline.barrier(("d2h", seq, logical))
                page = self.host_pages[(seq, logical)]
            else:
                page = self._page_planes_host(phys)
                nbytes = sum(_nbytes(a) for a in page.values())
                self.clock.charge(HOST_LINK, "write", nbytes,
                                  random_access=True)      # D2H page out
                self.stats["pool_d2h_bytes"] += nbytes
                self.stats["pool_page_spills"] += 1
                self._count_plane_bytes("pool_d2h_bytes", page)
            for name, arr in page.items():
                blobs[name][:, lo:hi] = arr[:, :hi - lo]
        return blobs

    def _drop_seq_pooled(self, seq: int) -> None:
        """Release ``seq``'s pages: shared pages only lose this sequence's
        refcount; a page returns to the free list when its last live user
        leaves AND the prefix index does not pin it. Spilled pages drop
        their host copy; state rows go with the sequence."""
        self.seq_state.pop(seq, None)
        for logical, phys in enumerate(self.block_table.pop(seq, [])):
            if phys >= 0:
                users = self.page_users.get(phys, {})
                users.pop(seq, None)
                if not users:
                    self.page_users.pop(phys, None)
                    if phys not in self.trie_refs:
                        self.pool_lru.remove(phys)
                        self.free_pages.append(phys)
            else:
                self.host_pages.pop((seq, logical), None)
        if self._pipeline is not None:
            # a later sequence may reuse this id: its (dir, seq, logical)
            # keys must not inherit this sequence's in-flight transfers
            self._pipeline.cancel_seq(seq)
        if self._share_index is not None:
            self._share_index.on_seq_dropped(seq)

    # ------------------------------------------------------------- host mode
    def _ensure_resident(self, layer: int, phys: int) -> None:
        key = (layer, phys)
        if key in self.hbm_lru:
            self.stats["hbm_hits"] += 1
            self.hbm_lru.touch(key)
            return
        self.stats["hbm_misses"] += 1
        if len(self.hbm_lru) >= self.hbm_capacity:
            self.hbm_lru.pop_lru()                   # clean: host copy is truth
        # DMA whole page up — the paper's miss-copy cost
        self.clock.charge(HOST_LINK, "read", self.spec.page_bytes,
                          random_access=True)
        self.stats["dma_up_bytes"] += self.spec.page_bytes
        self.hbm_lru.touch(key)

    def _touch_resident(self, layer: int, phys: int) -> None:
        """Mark the page being appended to as HBM-resident. The token just
        came out of the device, so the page is in the working set by
        construction — no DMA and no hit/miss accounting (those are
        read-path stats)."""
        if len(self.hbm_lru) >= self.hbm_capacity and \
                (layer, phys) not in self.hbm_lru:
            self.hbm_lru.pop_lru()
        self.hbm_lru.touch((layer, phys))

    def _append_tokens(self, seq: int, toks: list) -> None:
        if self._pooled:
            return self._append_tokens_pooled(seq, toks)
        spec = self.spec
        for kv_token in toks:
            pos = self.seq_len.get(seq, 0)
            logical = pos // spec.page_tokens
            slot = pos % spec.page_tokens
            table = self.block_table.setdefault(seq, [])
            if logical >= len(table):
                table.append(self.next_phys)
                self.next_phys += 1
                for layer in range(spec.num_layers):
                    self.pool[(layer, table[logical])] = spec.empty_page()
            phys = table[logical]
            for layer in range(spec.num_layers):
                # redo-buffer write then page write: the paging design's 2×
                self.clock.charge(HOST_LINK, "write", spec.token_bytes,
                                  random_access=False)       # redo append
                self.stats["redo_bytes"] += spec.token_bytes
                self.clock.charge(HOST_LINK, "write", spec.token_bytes,
                                  random_access=True)        # into the page
                self.stats["host_writes"] += 1
                self.pool[(layer, phys)][:, slot] = kv_token[layer]
                self._touch_resident(layer, phys)
            self.seq_len[seq] = pos + 1

    def _read(self, seq: int, layer: int) -> torch.Tensor:
        """Materialize ``(2, T, K, D)`` for attention; in host mode pages
        are DMA'd to HBM on miss (block-table indirection)."""
        if self._pooled:
            return self._read_pooled(seq, layer)
        spec = self.spec
        T = self.seq_len.get(seq, 0)
        out = torch.zeros((2, T, spec.kv_heads, spec.head_dim),
                          dtype=spec.dtype)
        for logical, phys in enumerate(self.block_table.get(seq, [])):
            self._ensure_resident(layer, phys)
            lo = logical * spec.page_tokens
            hi = min(lo + spec.page_tokens, T)
            if lo >= T:
                break
            out[:, lo:hi] = self.pool[(layer, phys)][:, :hi - lo]
            self.clock.charge(HBM, "read", (hi - lo) * spec.token_bytes)
        return out

    def _spill(self, seq: int) -> torch.Tensor:
        if self._pooled:
            raise RuntimeError(
                "pooled preemption goes through plane blobs, not the dense "
                "host spill hook")
        spec = self.spec
        T = self.seq_len.get(seq, 0)
        blob = torch.zeros((spec.num_layers, 2, T, spec.kv_heads,
                            spec.head_dim), dtype=spec.dtype)
        for logical, phys in enumerate(self.block_table.get(seq, [])):
            lo = logical * spec.page_tokens
            hi = min(lo + spec.page_tokens, T)
            if lo >= T:
                break
            for layer in range(spec.num_layers):
                blob[layer, :, lo:hi] = self.pool[(layer, phys)][:, :hi - lo]
        return blob

    def _drop_seq(self, seq: int) -> None:
        if self._pooled:
            return self._drop_seq_pooled(seq)
        for phys in self.block_table.pop(seq, []):
            for layer in range(self.spec.num_layers):
                self.pool.pop((layer, phys), None)
                self.hbm_lru.remove((layer, phys))

    # -------------------------------------------------------------- pressure
    def hbm_used_bytes(self) -> int:
        if not self._pooled:
            return len(self.hbm_lru) * self.spec.page_bytes
        if self._state_only:
            return len(self.seq_state) * self.desc.seq_state_bytes
        return (self.pool_pages - len(self.free_pages)) * self._group_bytes

    def hbm_limit_bytes(self) -> Optional[int]:
        if not self._pooled:
            return self.hbm_capacity * self.spec.page_bytes
        if self._state_only:
            return self._state_capacity * self.desc.seq_state_bytes
        return self.pool_pages * self._group_bytes

    def pressure(self) -> float:
        if not self._pooled:
            return super().pressure()
        if self._state_only:
            return min(len(self.seq_state) / self._state_capacity, 1.0)
        # count the pages the NEXT decode step will claim, so the scheduler
        # preempts one tick before allocation would have to spill pages of
        # the running batch itself; pages held only by the prefix index are
        # reclaimable on demand, so they count as headroom rather than load
        used = (self.pool_pages - len(self.free_pages)
                - self._idle_index_pages() + self._reserve_pages())
        return min(used / self.pool_pages, 1.0)

    def resident_bytes(self, seq: int) -> int:
        if not self._pooled:
            n = sum(1 for phys in self.block_table.get(seq, ())
                    for layer in range(self.spec.num_layers)
                    if (layer, phys) in self.hbm_lru)
            return n * self.spec.page_bytes
        if self._state_only:
            return self.desc.seq_state_bytes if seq in self.seq_state else 0
        n = sum(1 for phys in self.block_table.get(seq, ()) if phys >= 0)
        return n * self._group_bytes

    def victim_hint(self, candidates: Iterable[int]) -> Optional[int]:
        """Pooled mode: preempt the candidate whose eviction actually FREES
        the most device pool pages (only sole-user pages the prefix index
        does not pin count); ties rank by the hot/cold model (least
        re-reference mass), then by LRU coldness. Host mode has no
        opinion (the scheduler falls back to LRU), nor has a pool of state
        rows."""
        if not self._pooled or self._state_only:
            return None
        cands = list(candidates)
        if not cands:
            return None
        order = {phys: i for i, phys in enumerate(self.pool_lru.lru_order())}

        def key(seq):
            pages = [p for p in self.block_table.get(seq, ()) if p >= 0]
            freeable = [p for p in pages
                        if len(self.page_users.get(p, ())) == 1
                        and p not in self.trie_refs]
            heat = sum(self._heat.hotness(p) for p in freeable)
            coldest = min((order.get(p, len(order)) for p in pages),
                          default=len(order))
            return (-len(freeable), heat, coldest)
        return min(cands, key=key)


class _DrainingKV(_TieredKV):
    """Shared log/drain machinery for the log-structured designs.

    Appends go to a sequential host log (1× write) whose entries drain into
    compacted host pages through :class:`ShardedDrainer` — per-shard pending
    queues (``hash(seq) → shard``), each an independent FIFO server, so
    backlog on one shard never delays another. A per-sequence HBM hot
    window serves recent tokens; cold reads come from the compacted pages,
    patched from undrained log entries one by one on the host (the
    ``log_patch`` kernel's function; the reference reads the log the same
    way, without the kernel).
    """

    def __init__(self, spec: KVSpec, clock: SimClock, *,
                 hot_window_tokens: int, drain_batch: int, drain_shards: int,
                 hbm_budget_bytes: Optional[int] = None):
        super().__init__(spec, clock)
        self.hot_window = hot_window_tokens
        # the hot windows are the engine's HBM use: bound their TOTAL across
        # sequences to the budget (None = unbounded)
        per_token = spec.token_bytes * spec.num_layers
        self._hot_budget_tokens = (None if hbm_budget_bytes is None
                                   else max(hbm_budget_bytes // per_token, 1))
        self._hot_total = 0
        self._batch_depth = 0      # >0 inside append_many: advance once
        self.drain_batch = drain_batch
        self.drainer = ShardedDrainer(drain_shards)
        # per-shard pending log entries: (seq, pos, kv_token, finish)
        self.shard_log: list[deque] = [deque() for _ in range(drain_shards)]
        self._seq_pending: dict[int, int] = {}   # seq → undrained entries
        # compacted host pages, indexed per sequence so preempting one
        # sequence never scans the others: seq → (layer, logical) → page
        self.pages: dict[int, dict[tuple, torch.Tensor]] = {}
        # per-sequence HBM hot window (most recent tokens, all layers)
        self.hot: dict[int, deque] = {}
        self.stats.update({"log_appends": 0, "patches": 0, "hot_hits": 0,
                           "host_reads": 0, "host_writes": 0, "drained": 0,
                           "stall_time": 0.0})

    def pending_for(self, seq: int) -> int:
        """Undrained log entries for ``seq`` (0 after a force-drain)."""
        return self._seq_pending.get(seq, 0)

    # ---------------------------------------------------------------- drain
    def _drain_service(self) -> float:
        b = self.spec.token_bytes * self.spec.num_layers
        return HOST_LINK.write_latency / self.drain_batch + b / HOST_LINK.write_bw

    def _apply(self, seq: int, pos: int, kv_token: torch.Tensor) -> None:
        spec = self.spec
        logical, slot = divmod(pos, spec.page_tokens)
        seq_pages = self.pages.setdefault(seq, {})
        for layer in range(spec.num_layers):
            page = seq_pages.get((layer, logical))
            if page is None:
                page = spec.empty_page()
                seq_pages[(layer, logical)] = page
            page[:, slot] = kv_token[layer]

    def _advance(self, now: float) -> None:
        """Functionally apply every entry whose drain finished by ``now``."""
        for pending in self.shard_log:
            while pending and pending[0][3] <= now:
                seq, pos, kv_token, _ = pending.popleft()
                self._apply(seq, pos, kv_token)
                self._seq_pending[seq] -= 1
                if not self._seq_pending[seq]:
                    del self._seq_pending[seq]
                self.stats["drained"] += 1

    def _force_drain_seq(self, seq: int) -> None:
        """Stall until every pending entry of ``seq`` has drained. FIFO
        shard order means waiting for the sequence's newest entry drains
        everything it appended earlier too; other shards keep their own
        schedule."""
        if not self._seq_pending.get(seq, 0):
            return
        pending = self.shard_log[self.drainer.shard_of(seq)]
        finish = max(e[3] for e in pending if e[0] == seq)
        stall = max(0.0, finish - self.clock.now)
        if stall:
            self.stats["stall_time"] += stall
        self.clock.wait_until(finish)
        self._advance(self.clock.now)

    # --------------------------------------------------------------- append
    def _hot_push(self, seq: int, pos: int, kv_token: torch.Tensor) -> None:
        hot = self.hot.setdefault(seq, deque())
        hot.append((pos, kv_token.clone()))
        self._hot_total += 1
        if len(hot) > self.hot_window:       # per-sequence recency window
            hot.popleft()
            self._hot_total -= 1
        while (self._hot_budget_tokens is not None
               and self._hot_total > self._hot_budget_tokens):
            # global HBM budget: shrink the largest window first (evicted
            # tokens stay readable through the cold pages/patch path)
            victim = max(self.hot.values(), key=len)
            victim.popleft()
            self._hot_total -= 1

    def _log_takes_page(self, seq: int, logical: int) -> None:
        """Hook: the log (re)gains responsibility for a page (kvhybrid's
        ownership bookkeeping)."""

    def _log_owns(self, seq: int, logical: int) -> bool:
        """Hook: may the log patch this page on read? Always true for the
        pure log design; kvhybrid answers false for page-side-owned pages
        (reads trust the page side once ownership transferred)."""
        return True

    def _append_log(self, seq: int, toks: list) -> None:
        spec = self.spec
        shard = self.drainer.shard_of(seq)
        pending = self.shard_log[shard]
        for kv_token in toks:
            pos = self.seq_len.get(seq, 0)
            nbytes = spec.token_bytes * spec.num_layers
            # one sequential log write — the logging design's 1× write
            self.clock.charge(HOST_LINK, "write", nbytes, random_access=False)
            self.stats["host_writes"] += 1
            finish = self.drainer.push(shard, self.clock.now,
                                       self._drain_service())
            pending.append((seq, pos, kv_token.clone(), finish))
            self._seq_pending[seq] = self._seq_pending.get(seq, 0) + 1
            self.stats["log_appends"] += 1
            self._log_takes_page(seq, pos // spec.page_tokens)
            self._hot_push(seq, pos, kv_token)
            self.seq_len[seq] = pos + 1

    def append_many(self, items: Sequence[tuple]) -> None:
        """Batched multi-sequence append with ONE drainer advance for the
        whole batch (per-append advances are suppressed while inside)."""
        self._batch_depth += 1
        try:
            for seq, kv_tokens in items:
                self.append(seq, kv_tokens)
        finally:
            self._batch_depth -= 1
        self._advance(self.clock.now)

    # ----------------------------------------------------------------- read
    def _observe_read(self, seq: int, hot_tokens: int, cold_tokens: int,
                      latency_s: float) -> None:
        """Hook: reuse + gather-latency feedback for the adaptive router
        (kvhybrid)."""

    def _read(self, seq: int, layer: int) -> torch.Tensor:
        """(2, T, kv_heads, head_dim): hot window from HBM; cold history from
        compacted pages, patched from the log where the drainer hasn't
        caught up."""
        spec = self.spec
        t_read0 = self.clock.now
        self._advance(self.clock.now)
        T = self.seq_len.get(seq, 0)
        out = torch.zeros((2, T, spec.kv_heads, spec.head_dim),
                          dtype=spec.dtype)
        hot = self.hot.get(seq, ())
        hot_positions = set()
        for pos, kv_token in hot:
            out[:, pos] = kv_token[layer]
            hot_positions.add(pos)
        if hot_positions:
            self.stats["hot_hits"] += len(hot_positions)
            self.clock.charge(
                HBM, "read", len(hot_positions) * spec.token_bytes)
        cold_T = min(T, min(hot_positions) if hot_positions else T)
        npages = -(-cold_T // spec.page_tokens) if cold_T else 0
        seq_pages = self.pages.get(seq, {})
        for logical in range(npages):
            lo = logical * spec.page_tokens
            hi = min(lo + spec.page_tokens, cold_T)
            page = seq_pages.get((layer, logical))
            if page is not None:
                # only existing compacted pages cost host traffic; a still-
                # undrained page's tokens are charged by the patch loop below
                out[:, lo:hi] = page[:, :hi - lo]
                self.clock.charge(HOST_LINK, "read",
                                  (hi - lo) * spec.token_bytes,
                                  random_access=False)
                self.stats["host_reads"] += 1
        # patch undrained log entries overlapping the cold range — the
        # sequence's entries live only in its own shard (hash(seq) → shard),
        # so other shards' backlogs are never scanned
        pending = self.shard_log[self.drainer.shard_of(seq)]
        for seq_i, pos, kv_token, _ in pending:
            if (seq_i == seq and pos < cold_T and pos not in hot_positions
                    and self._log_owns(seq, pos // spec.page_tokens)):
                out[:, pos] = kv_token[layer]
                self.clock.charge(HOST_LINK, "read", spec.token_bytes,
                                  random_access=True)
                self.stats["patches"] += 1
        self._observe_read(seq, len(hot_positions), max(cold_T, 0),
                           self.clock.now - t_read0)
        return out

    def _spill(self, seq: int) -> torch.Tensor:
        spec = self.spec
        T = self.seq_len.get(seq, 0)
        blob = torch.zeros((spec.num_layers, 2, T, spec.kv_heads,
                            spec.head_dim), dtype=spec.dtype)
        # compacted pages first, then undrained log entries on top (FIFO) —
        # together they hold every appended token; the hot window is only a
        # cache of the same data
        for (layer, logical), page in self.pages.get(seq, {}).items():
            lo = logical * spec.page_tokens
            hi = min(lo + spec.page_tokens, T)
            if lo < T:
                blob[layer, :, lo:hi] = page[:, :hi - lo]
        for seq_i, pos, kv_token, _ in self.shard_log[
                self.drainer.shard_of(seq)]:
            if seq_i == seq:
                blob[:, :, pos] = kv_token
        return blob

    def _drop_seq(self, seq: int) -> None:
        self._hot_total -= len(self.hot.pop(seq, ()))
        self.pages.pop(seq, None)
        if self._seq_pending.pop(seq, None):
            shard = self.drainer.shard_of(seq)
            self.shard_log[shard] = deque(
                e for e in self.shard_log[shard] if e[0] != seq)

    # -------------------------------------------------------------- pressure
    def hbm_used_bytes(self) -> int:
        return self._hot_total * self.spec.token_bytes * self.spec.num_layers

    def hbm_limit_bytes(self) -> Optional[int]:
        if self._hot_budget_tokens is None:
            return None
        return (self._hot_budget_tokens * self.spec.token_bytes
                * self.spec.num_layers)

    def resident_bytes(self, seq: int) -> int:
        return (len(self.hot.get(seq, ())) * self.spec.token_bytes
                * self.spec.num_layers)


@register_kv_engine("log")
class LogKVCache(_DrainingKV):
    """NVLog design: sequential host log + HBM hot window + drain/compact."""

    def __init__(self, spec: KVSpec, clock: SimClock, *,
                 hot_window_tokens: int = 256, drain_batch: int = 32,
                 drain_shards: int = 1,
                 hbm_budget_bytes: Optional[int] = None):
        super().__init__(spec, clock, hot_window_tokens=hot_window_tokens,
                         drain_batch=drain_batch, drain_shards=drain_shards,
                         hbm_budget_bytes=hbm_budget_bytes)

    @classmethod
    def from_spec(cls, spec: EngineSpec, kvspec: KVSpec,
                  clock: SimClock) -> "LogKVCache":
        return cls(kvspec, clock, hot_window_tokens=spec.kv_hot_window,
                   drain_batch=spec.drain_batch,
                   drain_shards=spec.drain_shards,
                   hbm_budget_bytes=spec.kv_hbm_bytes)

    def _append_tokens(self, seq: int, toks: list) -> None:
        self._append_log(seq, toks)
        if not self._batch_depth:
            self._advance(self.clock.now)


class AdaptiveRouter:
    """Online log-vs-pages routing policy for :class:`HybridKVCache`.

    Keeps a log2 histogram of observed append sizes plus hot/cold read
    counters and a gather-latency EMA, and re-learns the byte threshold
    every ``update_every`` appends (appends below the threshold route to
    the log hot-window path, the rest to pages):

    * **bimodal** sizes (decode tokens vs prefill bursts): the threshold
      sits in the widest histogram valley, nudged toward the log side when
      the hot window serves most reads and toward the page side when reads
      are cold-heavy or gathers run slow;
    * **unimodal small** (< page granularity): everything logs — the
      threshold parks at 4× the mode, capped at one page;
    * **unimodal large** (≥ one page): everything pages.

    **Latency feedback:** the router keeps an EMA of observed per-token
    gather latency and compares it to ``page_per_token_s`` — the modelled
    cost of serving the same token from a compacted page — and biases the
    threshold toward pages when gathers run hot.

    Per-sequence hot/cold counters (``seq_reuse``) feed
    :meth:`HybridKVCache.victim_hint`: under HBM pressure the scheduler
    preempts the sequence whose reads reuse the hot window least.
    """

    #: observed-vs-modelled gather cost ratio above which gathers count as
    #: slow (bias toward pages) / below which as cheap (keep the log)
    SLOW_GATHER_RATIO = 2.0
    FAST_GATHER_RATIO = 1.2

    def __init__(self, threshold_bytes: int, page_bytes: int, *,
                 update_every: int = 16,
                 page_per_token_s: Optional[float] = None):
        self.threshold = max(int(threshold_bytes), 1)
        self.page_bytes = page_bytes
        self.update_every = update_every
        self.page_per_token_s = page_per_token_s
        self.hist: dict[int, int] = {}    # log2 bucket → append count
        self.hot_reads = 0
        self.cold_reads = 0
        self.gather_lat_s: Optional[float] = None   # per-token EMA
        self.seq_reuse: dict[int, list[int]] = {}   # seq → [hot, cold]
        self._n = 0

    def observe_read(self, seq: int, hot_tokens: int, cold_tokens: int,
                     latency_s: float = 0.0) -> None:
        self.hot_reads += hot_tokens
        self.cold_reads += cold_tokens
        reuse = self.seq_reuse.setdefault(seq, [0, 0])
        reuse[0] += hot_tokens
        reuse[1] += cold_tokens
        tokens = hot_tokens + cold_tokens
        if tokens and latency_s > 0.0:
            per_tok = latency_s / tokens
            self.gather_lat_s = (per_tok if self.gather_lat_s is None
                                 else 0.8 * self.gather_lat_s + 0.2 * per_tok)

    def reuse_score(self, seq: int) -> Optional[float]:
        """Hot-window share of this sequence's observed reads (None = never
        read). Low score = cold sequence = cheap preemption victim."""
        reuse = self.seq_reuse.get(seq)
        if reuse is None or (reuse[0] + reuse[1]) == 0:
            return None
        return reuse[0] / (reuse[0] + reuse[1])

    def forget_seq(self, seq: int) -> None:
        """Drop per-sequence reuse state (finished request)."""
        self.seq_reuse.pop(seq, None)

    def _latency_bias(self) -> float:
        """Extra threshold bias from *observed* gather latency: slow gathers
        (≫ the modelled page-read cost) push appends toward pages, cheap
        ones keep the log attractive."""
        if self.gather_lat_s is None or not self.page_per_token_s:
            return 0.0
        ratio = self.gather_lat_s / self.page_per_token_s
        if ratio > self.SLOW_GATHER_RATIO:
            return -1.0                     # gathers hurt → favor pages
        if ratio < self.FAST_GATHER_RATIO:
            return 0.25                     # gathers cheap → keep logging
        return 0.0

    def route(self, nbytes: int) -> str:
        """Record one append of ``nbytes`` and return ``"log"``/``"pages"``."""
        self.hist[nbytes.bit_length()] = \
            self.hist.get(nbytes.bit_length(), 0) + 1
        self._n += 1
        if self._n % self.update_every == 0:
            self._relearn()
        return "log" if nbytes < self.threshold else "pages"

    def _relearn(self) -> None:
        buckets = sorted(self.hist)
        total = sum(self.hist.values())
        # drop noise buckets (<2% of mass) so a stray append can't masquerade
        # as a mode
        buckets = [b for b in buckets
                   if self.hist[b] >= max(total * 0.02, 1)] or buckets
        gap_mid, gap_w = None, 1
        for lo, hi in zip(buckets, buckets[1:]):
            if hi - lo > gap_w:
                gap_w, gap_mid = hi - lo, (lo + hi) / 2
        if gap_mid is not None:
            # bimodal: split at the valley, biased by observed reuse and by
            # the measured gather-latency-vs-page-cost ratio
            reads = self.hot_reads + self.cold_reads
            bias = 0.0
            if reads:
                if self.cold_reads > 0.75 * reads:
                    bias = -0.5        # cold-heavy reuse → favor pages
                elif self.hot_reads > 0.75 * reads:
                    bias = 0.5         # hot-window reuse → favor the log
            bias = max(-1.5, min(1.5, bias + self._latency_bias()))
            self.threshold = int(2 ** (gap_mid + bias))
            return
        mode = max(buckets, key=lambda b: self.hist[b])
        mode_size = 1 << max(mode - 1, 0)
        if mode_size >= self.page_bytes:
            self.threshold = self.page_bytes       # page-sized: route pages
        else:
            self.threshold = min(4 * mode_size, self.page_bytes)


@register_kv_engine("kvhybrid")
class HybridKVCache(_DrainingKV):
    """The combined design: adaptive log/pages routing + sharded drainers.

    Small appends take the log path (1× sequential host write, HBM hot
    window, per-shard background drain into host pages); large appends write
    host pages directly (no redo write for fully covered pages). Coherence:
    before the page side takes ownership of a sequence's pages, that
    sequence's drain shard is force-drained — log entries always reach the
    pages before page-side writes land on top (log-before-pages ordering).
    """

    def __init__(self, spec: KVSpec, clock: SimClock, *,
                 hbm_budget_bytes: int, hot_window_tokens: int = 256,
                 drain_batch: int = 32, drain_shards: int = 1,
                 threshold_bytes: int = 2048):
        super().__init__(spec, clock, hot_window_tokens=hot_window_tokens,
                         drain_batch=drain_batch, drain_shards=drain_shards,
                         hbm_budget_bytes=hbm_budget_bytes)
        # pages whose pending state the page side owns: seq → {logical}
        self.page_owned: dict[int, set[int]] = {}
        # modelled cost of serving one token from a compacted page — the
        # reference the router's gather-latency feedback compares against
        page_per_token = (HOST_LINK.read_latency / spec.page_tokens
                          + spec.token_bytes / HOST_LINK.read_bw)
        self.router = AdaptiveRouter(threshold_bytes, spec.page_bytes,
                                     page_per_token_s=page_per_token)
        self.stats.update({"routed_log": 0, "routed_pages": 0,
                           "page_appends": 0, "force_drains": 0,
                           "redo_bytes": 0})

    @classmethod
    def from_spec(cls, spec: EngineSpec, kvspec: KVSpec,
                  clock: SimClock) -> "HybridKVCache":
        return cls(kvspec, clock, hbm_budget_bytes=spec.kv_hbm_bytes,
                   hot_window_tokens=spec.kv_hot_window,
                   drain_batch=spec.drain_batch,
                   drain_shards=spec.drain_shards,
                   threshold_bytes=spec.hybrid_threshold)

    @property
    def threshold(self) -> int:
        """Current learned routing threshold in bytes (a gauge, not a
        counter — deliberately not part of ``stats``)."""
        return self.router.threshold

    def _log_takes_page(self, seq: int, logical: int) -> None:
        # the log side owns this page again (reads patch from the log)
        owned = self.page_owned.get(seq)
        if owned:
            owned.discard(logical)

    def _log_owns(self, seq: int, logical: int) -> bool:
        # ownership is what reads trust: once the page side took a page
        # (after the force-drain), the log never patches it again
        return logical not in self.page_owned.get(seq, ())

    def _observe_read(self, seq: int, hot_tokens: int, cold_tokens: int,
                      latency_s: float) -> None:
        self.router.observe_read(seq, hot_tokens, cold_tokens, latency_s)

    def victim_hint(self, candidates: Iterable[int]) -> Optional[int]:
        """Preemption victim from the router's per-sequence reuse histogram:
        the candidate whose reads reuse the hot window least, ties broken
        toward the largest HBM footprint. ``None`` when no candidate has
        been read yet — the scheduler then falls back to LRU."""
        scored = [(self.router.reuse_score(seq), seq) for seq in candidates]
        if all(score is None for score, _ in scored):
            return None
        # unread sequences score neutral: known-cold beats unknown
        return min(scored, key=lambda sv: (
            0.5 if sv[0] is None else sv[0],
            -self.resident_bytes(sv[1])))[1]

    def _append_pages(self, seq: int, toks: list) -> None:
        spec = self.spec
        start = self.seq_len.get(seq, 0)
        end = start + len(toks)
        # ownership handover: this sequence's log entries must reach the
        # pages before the page side writes on top of them
        self._force_drain_seq(seq)
        for i, kv_token in enumerate(toks):
            pos = start + i
            logical = pos // spec.page_tokens
            page_lo = logical * spec.page_tokens
            page_hi = page_lo + spec.page_tokens
            full_page = start <= page_lo and page_hi <= end
            nbytes = spec.token_bytes * spec.num_layers
            if full_page:
                # fully covered page: one sequential write, no redo
                self.clock.charge(HOST_LINK, "write", nbytes,
                                  random_access=False)
            else:
                # partial page: redo append + in-place page write (the
                # paging design's 2× for sub-page writes)
                self.clock.charge(HOST_LINK, "write", nbytes,
                                  random_access=False)
                self.clock.charge(HOST_LINK, "write", nbytes,
                                  random_access=True)
                self.stats["redo_bytes"] += nbytes
            self.stats["host_writes"] += 1
            self._apply(seq, pos, kv_token)
            self.page_owned.setdefault(seq, set()).add(logical)
            self.stats["page_appends"] += 1
            self._hot_push(seq, pos, kv_token)
            self.seq_len[seq] = pos + 1

    def _force_drain_seq(self, seq: int) -> None:
        if self.pending_for(seq):
            super()._force_drain_seq(seq)
            self.stats["force_drains"] += 1

    def _append_tokens(self, seq: int, toks: list) -> None:
        nbytes = len(toks) * self.spec.token_bytes * self.spec.num_layers
        route = self.router.route(nbytes)
        if route == "log":
            self.stats["routed_log"] += 1
            self._append_log(seq, toks)
        else:
            self.stats["routed_pages"] += 1
            self._append_pages(seq, toks)
        if not self._batch_depth:
            self._advance(self.clock.now)

    def _drop_seq(self, seq: int) -> None:
        super()._drop_seq(seq)
        self.page_owned.pop(seq, None)

    def _on_release(self, seq: int) -> None:
        self.router.forget_seq(seq)
