"""Tiered KV cache, pooled paging design (NVPages) on a torch device.

The port's copy of the JAX package's ``paged`` KV engine in its pooled
mode: fixed-size token pages live in device-resident ``(L, P, T, *shape)``
torch tensors (one per descriptor plane) that the paged-attention kernel
reads directly through a block table; page alloc/free is tied to an LRU
and a hot/cold model, and when the fixed pool fills, the coldest page of a
non-pinned sequence is *spilled to the host tier at page granularity*
(D2H one page) and faulted back on demand (H2D). Host copies are CPU
torch tensors (numpy has no bfloat16).

Data movement is real; PCIe/HBM/disk *time* is modeled by the SimClock
with the same tier constants the JAX package charges (``HOST_LINK`` and
``HBM`` below), so byte counters and simulated-time counters compare 1:1
with the reference. They are a simulation's inputs, not a GPU's speed.

Pages may be shared: a prefix index (``serving/prefix_cache.py``) pins
pages, admission splices them into a new sequence's block table, and the
first write inside a page other live sequences still read copies it
(copy-on-write). A fault injector (``serving/faults.py``) may fail tier
transfers and lose spilled host pages.

The ``log`` and ``kvhybrid`` designs, the paged engine's host mode and the
per-sequence state rows of the SSM family wait for later slices of the
port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.clock import SimClock
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


class _TieredKV(KVCacheEngine):
    """Shared engine plumbing: the host-facing append/read protocol, the
    preempted-sequence guard, release, and the uniform stats key set.
    Engines implement ``_append_tokens`` / ``_read`` / ``_drop_seq``."""

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

    def _on_release(self, seq: int) -> None:
        """Hook: per-sequence policy-state cleanup on release."""

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
    """NVPages design over device-resident ``(L, P, T, *shape)`` page
    planes (the mirror-free serving path).

    Decode and prefill appends are device-born: the model scatters them in
    place into the pool tensors (:meth:`pool_views` hands out the engine's
    own tensors) and :meth:`commit_step_planes` / :meth:`commit_prefill_planes`
    advance the accounting — HBM writes only, zero device→host traffic.
    Every method requires :meth:`init_pool` first: the reference's host
    mode is not ported.
    """

    def __init__(self, spec: KVSpec, clock: SimClock, *,
                 hbm_budget_bytes: int, async_tiering: bool = False,
                 transfer_max_retries: int = 3,
                 transfer_backoff_s: float = 1e-4):
        super().__init__(spec, clock)
        self.block_table: dict[int, list[int]] = {}  # seq → [phys per logical]
        self.hbm_budget_bytes = hbm_budget_bytes
        self._pooled = False
        self.async_tiering = bool(async_tiering)
        self._pipeline = None          # TransferPipeline once pooled + async
        self._share_index = None       # prefix index (set_share_index)
        self._injector = None          # FaultInjector (set_fault_injector)
        self._xfer_retries = transfer_max_retries
        self._xfer_backoff = transfer_backoff_s

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
                "the port's paged engine runs pooled only; call init_pool() "
                "first (host mode is not ported)")

    def init_pool(self, dtype=None, pages: Optional[int] = None,
                  device="cuda") -> None:
        """Allocate the device page pool on ``device``: one zeroed
        ``(L, P, T, *shape)`` tensor per descriptor plane, ``P`` sized
        from the HBM budget unless ``pages`` overrides it."""
        if self._pooled:
            raise RuntimeError("init_pool() called twice")
        if self.seq_len or self._preempted:
            raise RuntimeError("init_pool() must run before any append")
        spec = self.spec
        desc = spec.descriptor()
        if dtype is not None:
            desc = desc.with_kv_dtype(dtype)
        if desc.page_tokens != spec.page_tokens:
            raise ValueError(
                f"descriptor page_tokens={desc.page_tokens} disagrees with "
                f"KVSpec page_tokens={spec.page_tokens}")
        if not desc.has_pages:
            raise NotImplementedError(
                "state-row descriptors (SSM) are not ported yet (ROADMAP.md, "
                "queue 1: Families: the other dense configs, MoE and SSM)")
        self.desc = desc
        self.device = torch.device(device)
        self._plane_names = tuple(p.name for p in desc.paged_planes)
        kv_planes = [p for p in desc.paged_planes if p.kind == "kv"]
        self.pool_dtype = kv_planes[0].torch_dtype
        # one physical page spans every layer and every plane (the block
        # table is shared by the whole stack), so a page group costs L
        # per-layer pages of HBM summed across the descriptor's planes
        self._group_bytes = desc.page_group_bytes
        self.pool_pages = (pages if pages is not None else
                           max(self.hbm_budget_bytes // self._group_bytes, 1))
        self.dev_planes: dict = {}
        for p in desc.paged_planes:
            shape = ((spec.num_layers, self.pool_pages, spec.page_tokens)
                     + tuple(p.shape))
            self.dev_planes[p.name] = torch.zeros(shape, dtype=p.torch_dtype,
                                                  device=self.device)
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
        if not self._pooled:
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
        if not self._pooled:
            return
        for seq in seqs:
            if seq in self.block_table:
                self._rewind_step_pages(seq)

    def stall_transfers(self, direction: int, seconds: float) -> None:
        if self._pooled and self._pipeline is not None:
            self._pipeline.stall_channel(direction, seconds)

    # ------------------------------------------------------- prefix sharing
    def supports_sharing(self) -> bool:
        return self._pooled

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

    def state_views(self, seqs: Sequence[int]):
        raise NotImplementedError(
            "per-sequence state rows (SSM) are not ported yet (ROADMAP.md, "
            "queue 1: Families: the other dense configs, MoE and SSM)")

    # --------------------------------------------- pooled preempt / restore
    def preempt(self, seq: int) -> None:
        """Pooled preemption spills PLANE blobs (one token-exact host
        tensor per paged plane): the layout leaves the pool the same way
        it lives in it."""
        self._require_pool()
        self._check_active(seq)
        length = self.seq_len.get(seq, 0)
        blobs = self._spill_pooled_planes(seq)
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
        self._require_pool()
        item = self._preempted.pop(seq, None)
        if item is None:
            raise RuntimeError(f"sequence {seq} is not preempted")
        length, blobs = item
        nbytes = sum(_nbytes(a) for a in blobs.values())
        self.clock.charge(SSD, "read", nbytes, random_access=False)
        self.stats["restores"] += 1
        self.stats["restore_in_bytes"] += nbytes
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
    def _append_tokens(self, seq: int, toks: list) -> None:
        """Host-facing append (the sequential reference's mirror): scatter
        ``(L, 2, K, D)`` tokens into the device pool in place. Models
        device-born tokens (HBM write only). Dense ``(k, v)`` only."""
        self._require_pool()
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

    def _read(self, seq: int, layer: int) -> torch.Tensor:
        """Materialize ``(2, T, K, D)`` of ``layer`` on the host in the
        KVSpec dtype (dense pools only)."""
        self._require_pool()
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

    def _drop_seq(self, seq: int) -> None:
        """Release ``seq``'s pages: shared pages only lose this sequence's
        refcount; a page returns to the free list when its last live user
        leaves AND the prefix index does not pin it. Spilled pages drop
        their host copy."""
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

    # -------------------------------------------------------------- pressure
    def hbm_used_bytes(self) -> int:
        if not self._pooled:
            return 0
        return (self.pool_pages - len(self.free_pages)) * self._group_bytes

    def hbm_limit_bytes(self) -> Optional[int]:
        if not self._pooled:
            return None
        return self.pool_pages * self._group_bytes

    def pressure(self) -> float:
        if not self._pooled:
            return 0.0
        # count the pages the NEXT decode step will claim, so the scheduler
        # preempts one tick before allocation would have to spill pages of
        # the running batch itself; pages held only by the prefix index are
        # reclaimable on demand, so they count as headroom rather than load
        used = (self.pool_pages - len(self.free_pages)
                - self._idle_index_pages() + self._reserve_pages())
        return min(used / self.pool_pages, 1.0)

    def resident_bytes(self, seq: int) -> int:
        if not self._pooled:
            return 0
        n = sum(1 for phys in self.block_table.get(seq, ()) if phys >= 0)
        return n * self._group_bytes

    def victim_hint(self, candidates: Iterable[int]) -> Optional[int]:
        """Preempt the candidate whose eviction actually FREES the most
        device pool pages (only sole-user pages the prefix index does not
        pin count); ties rank
        by the hot/cold model (least re-reference mass), then by LRU
        coldness."""
        if not self._pooled:
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
