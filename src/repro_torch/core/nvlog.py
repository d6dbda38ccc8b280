"""NVLog: the paper's logging design (Fig. 2), NVCache [DSN'21] as a library.

``pwrite`` appends one record to a sequential NVMM log (durable at return).
A background drainer continuously applies log entries to disk *through the
LPC in batches followed by fsync* (benefiting from LPC write merging, as the
paper describes). Reads are served from a small DRAM page cache; on miss the
base page comes from the LPC/disk and pending log entries are *patched* in.
A per-page pending map tracks which pages need patching so the NVMM log is
only searched when necessary (paper §II).

The drainer is simulated as an analytic FIFO queue
(repro_torch.core.clock): entry finish-times determine foreground stalls
(log full) and the crash cut-off (which entries were durably applied at
crash time).

Beyond-paper option: ``log_shards > 1`` (per-shard logs + drainers — the
sharded-log design the paper suggests would be needed for multithreading).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.clock import ShardedDrainer, SimClock
from repro_torch.core.disk import Disk, PAGE_SIZE, iter_page_chunks
from repro_torch.core.lru import LRUList
from repro_torch.core.wal import CircularWAL, HEADER_SIZE, LogRecord
from repro_torch.roofline.hw import DRAM, NVMM, SSD, SSD_FSYNC_LATENCY


@dataclass
class _PendingEntry:
    logical: int         # record start in the WAL
    record: LogRecord
    finish_time: float   # drain durability point (simulated)


class _LogShard:
    def __init__(self, capacity: int, merge_window: int = 256):
        self.wal = CircularWAL(capacity)
        self.pending: deque[_PendingEntry] = deque()
        # sliding window of recently logged page numbers: models the LPC
        # merging writes to the same page within the drain backlog
        # (paper §II: "merging consecutive writes on the same offset")
        self.recent_pages: deque = deque(maxlen=merge_window)


class NVLog:
    def __init__(self, nvmm_bytes: int, disk: Disk, clock: SimClock, *,
                 dram_cache_bytes: int = 2 << 30, drain_batch: int = 64,
                 log_shards: int = 1):
        self.disk = disk
        self.clock = clock
        self.drain_batch = drain_batch
        shard_bytes = nvmm_bytes // log_shards
        # every shard must be able to hold at least two max-size records
        # (one draining + one arriving), or pwrite's stall-until-drained
        # loop can never make progress
        min_shard = 2 * (HEADER_SIZE + PAGE_SIZE)
        if shard_bytes < min_shard:
            raise ValueError(
                f"log_shards={log_shards} leaves {shard_bytes} bytes of WAL "
                f"per shard; each shard needs >= {min_shard} bytes — lower "
                f"drain_shards/shards or raise nvmm_bytes")
        self.num_shards = log_shards
        self.shards = [_LogShard(shard_bytes) for _ in range(log_shards)]
        # per-shard drainers: each WAL shard is an independent FIFO server
        self.drainer = ShardedDrainer(log_shards)
        # small DRAM page cache with up-to-date pages (paper: 2 GiB)
        self.dram_capacity = max(dram_cache_bytes // PAGE_SIZE, 1)
        self.dram: dict[int, bytearray] = {}
        self.dram_lru = LRUList()
        # pages with log entries not yet applied to disk → must patch on miss
        self.needs_patch: dict[int, list[_PendingEntry]] = {}
        self.stats = {"log_appends": 0, "dram_hits": 0, "dram_misses": 0,
                      "patches_applied": 0, "stall_time": 0.0}

    # --------------------------------------------------------------- drainer
    def _stall_until(self, t: float) -> None:
        """Foreground blocks on the drainer: account the stall, jump the
        clock, apply everything that finished by then."""
        stall = max(0.0, t - self.clock.now)
        if stall:
            self.stats["stall_time"] += stall
        self.clock.wait_until(t)
        self._advance_drainer(self.clock.now)

    def _drain_service_time(self, sh: "_LogShard", pno: int) -> float:
        """Per-entry drain cost: submit to LPC + amortized batched fsync.

        The SSD portion is scaled by the unique-page ratio of the drain
        window — the LPC merges same-page writes before writeback (paper
        §II), so hot (zipf) write streams cost less disk traffic."""
        sh.recent_pages.append(pno)
        uniq = len(set(sh.recent_pages)) / len(sh.recent_pages)
        lpc_write = DRAM.write_latency + PAGE_SIZE / DRAM.write_bw
        # batched writeback: the LPC submits whole fsync batches, so the SSD
        # sees deep-queue bursts (≈ sequential bandwidth, amortized latency)
        # — unlike NVPages' synchronous one-page random evictions. This is
        # the second asymmetry the logging design exploits (paper §II).
        ssd_write = uniq * (SSD.write_latency / self.drain_batch
                            + PAGE_SIZE / SSD.write_bw)
        return lpc_write + ssd_write + SSD_FSYNC_LATENCY / self.drain_batch

    def _apply_entry(self, entry: _PendingEntry) -> None:
        rec = entry.record
        pno = rec.offset // PAGE_SIZE
        self.disk.apply_silent(pno, rec.offset % PAGE_SIZE, rec.payload)
        lst = self.needs_patch.get(pno)
        if lst:
            try:
                lst.remove(entry)
            except ValueError:
                pass
            if not lst:
                del self.needs_patch[pno]

    def _advance_drainer(self, upto_time: float) -> None:
        """Functionally apply every entry whose drain finished by ``upto_time``."""
        for sh in self.shards:
            while sh.pending and sh.pending[0].finish_time <= upto_time:
                entry = sh.pending.popleft()
                self._apply_entry(entry)
                nxt = (sh.pending[0].record.seqno if sh.pending
                       else sh.wal.next_seqno)
                end = (sh.pending[0].logical if sh.pending else sh.wal.head)
                sh.wal.reclaim_to(end, nxt)

    # ------------------------------------------------------------ DRAM cache
    def _dram_put(self, pno: int, data: bytearray) -> None:
        if pno not in self.dram and len(self.dram) >= self.dram_capacity:
            victim = self.dram_lru.pop_lru()
            if victim is not None:
                self.dram.pop(victim, None)   # clean drop: log is truth
        self.dram[pno] = data
        self.dram_lru.touch(pno)

    # -------------------------------------------------------------------- IO
    def pwrite(self, offset: int, data: bytes) -> int:
        for pos, pno, in_page, n in iter_page_chunks(offset, len(data)):
            chunk = data[pos:pos + n]
            shard_idx = pno % self.num_shards
            sh = self.shards[shard_idx]
            rec_size = sh.wal.record_size(n)
            # stall if the log is full until the drainer frees space
            while sh.wal.free < rec_size:
                assert sh.pending, "log full but nothing to drain"
                self._stall_until(sh.pending[0].finish_time)
            logical = sh.wal.head
            rec = sh.wal.append(offset + pos, chunk)
            self.clock.charge(NVMM, "write", rec_size, random_access=False)
            self.stats["log_appends"] += 1
            finish = self.drainer.push(shard_idx, self.clock.now,
                                       self._drain_service_time(sh, pno))
            entry = _PendingEntry(logical, rec, finish)
            sh.pending.append(entry)
            self.needs_patch.setdefault(pno, []).append(entry)
            # keep fresh pages in DRAM (paper §III): update-if-present, and
            # write-allocate on *full-page* writes (no base page needed);
            # partial writes to absent pages ride on the patch tracking
            page = self.dram.get(pno)
            if page is not None:
                self.clock.charge(DRAM, "write", n)
                page[in_page:in_page + n] = chunk
                self.dram_lru.touch(pno)
            elif in_page == 0 and n == PAGE_SIZE:
                self.clock.charge(DRAM, "write", n)
                self._dram_put(pno, bytearray(chunk))
        self._advance_drainer(self.clock.now)
        return len(data)

    def _materialize_page(self, pno: int) -> bytearray:
        """Base page from LPC/disk + patches from the NVMM log."""
        base = bytearray(self.disk.read_page(pno))
        entries = self.needs_patch.get(pno)
        if entries:
            for entry in list(entries):
                rec = entry.record
                self.clock.charge(NVMM, "read", rec.size)
                base[rec.offset % PAGE_SIZE:
                     rec.offset % PAGE_SIZE + len(rec.payload)] = rec.payload
                self.stats["patches_applied"] += 1
        return base

    def pread(self, offset: int, n: int) -> bytes:
        self._advance_drainer(self.clock.now)
        out = bytearray()
        for _, pno, in_page, take in iter_page_chunks(offset, n):
            page = self.dram.get(pno)
            if page is not None:
                # the paper's headline advantage: reads at DRAM bandwidth
                self.clock.charge(DRAM, "read", take)
                self.dram_lru.touch(pno)
                self.stats["dram_hits"] += 1
            else:
                self.stats["dram_misses"] += 1
                page = self._materialize_page(pno)
                self.clock.charge(DRAM, "write", PAGE_SIZE)
                self._dram_put(pno, page)
            out += page[in_page:in_page + take]
        return bytes(out)

    def fsync(self) -> None:
        """No-op: pwrite is already durable at return (data is in the log)."""

    def nvmm_capacity_bytes(self) -> int:
        """NVMM actually provisioned: the shard WALs."""
        return sum(sh.wal.capacity for sh in self.shards)

    def nvmm_used_bytes(self) -> int:
        """Live NVMM footprint: un-reclaimed WAL bytes across shards."""
        return sum(sh.wal.used for sh in self.shards)

    # ------------------------------------------------- hybrid-engine hooks
    def has_pending(self, pno: int) -> bool:
        """True if the drainer still owes disk some entries for ``pno``."""
        return pno in self.needs_patch

    def force_drain_page(self, pno: int) -> None:
        """Stall until every pending entry for ``pno`` is applied to disk.

        FIFO drain order means waiting for the page's newest entry drains
        everything appended before it too — the ordering handover the
        hybrid engine relies on (log drains before the page side takes
        ownership of a page).
        """
        entries = self.needs_patch.get(pno)
        if not entries:
            return
        self._stall_until(entries[-1].finish_time)

    def invalidate(self, pno: int) -> None:
        """Drop the DRAM-cached copy of ``pno`` (another engine component
        took ownership of the page and will serve newer data)."""
        if self.dram.pop(pno, None) is not None:
            self.dram_lru.remove(pno)

    # -------------------------------------------------------- crash / recovery
    def drain_all(self) -> None:
        """Block until the drainer is idle (clean shutdown)."""
        for sh in self.shards:
            if sh.pending:
                self.clock.wait_until(sh.pending[-1].finish_time)
        self._advance_drainer(self.clock.now)

    def crash(self) -> None:
        """DRAM cache and LPC are lost. Entries whose drain had finished by
        now are on the SSD; the rest survive only in the NVMM log."""
        self._advance_drainer(self.clock.now)
        self.dram.clear()
        self.dram_lru = LRUList()
        self.needs_patch.clear()
        for sh in self.shards:
            sh.pending.clear()
        self.drainer.reset()
        self.disk.crash()

    def recover(self, *, barrier: bool = True) -> None:
        """Replay every record still in the NVMM log to disk (paper §II:
        'flushing to disk every modification still pending in cache').

        ``barrier=False`` skips the terminal fsync — for composition (the
        hybrid engine runs one shared barrier after its page flush instead
        of paying SSD_FSYNC_LATENCY once per component)."""
        for sh in self.shards:
            records = sh.wal.recover_scan()
            for rec in records:
                self.clock.charge(NVMM, "read", rec.size)
                pno = rec.offset // PAGE_SIZE
                self.disk.write_page_lpc(pno, bytes(
                    self._patched_base_for_recovery(pno, rec)))
            sh.wal.reclaim_to(sh.wal.head, sh.wal.next_seqno)
        if barrier:
            self.disk.fsync()

    def _patched_base_for_recovery(self, pno: int, rec: LogRecord) -> bytearray:
        base = bytearray(self.disk.read_page(pno))
        off = rec.offset % PAGE_SIZE
        base[off:off + len(rec.payload)] = rec.payload
        return base
