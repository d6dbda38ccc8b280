"""NVPages: the paper's paging design (Fig. 1).

4 KiB pages live in NVMM; a volatile radix tree maps page number → frame
metadata; ``pwrite`` goes through a redo log in NVMM *then* into the NVMM
page (the 2× write the paper calls out); eviction is LRU; cache misses copy
the missing page into NVMM (the miss cost the paper calls out). Frame
headers (page_no, dirty) are kept in NVMM so crash recovery can flush every
pending modification to disk.

Beyond-paper option (the paper's own future-work §IV): ``shards > 1`` gives
independent redo logs + frame pools per page-number shard, the design the
authors argue makes paging multithread-friendly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.clock import SimClock
from repro_torch.core.disk import (Disk, PAGE_SIZE, _ZERO_PAGE,
                                   iter_page_chunks)
from repro_torch.core.lru import LRUList
from repro_torch.core.radix import RadixTree
from repro_torch.core.wal import CircularWAL
from repro_torch.roofline.hw import NVMM


@dataclass
class Frame:
    frame_id: int
    page_no: int
    dirty: bool


class _Shard:
    def __init__(self, frames: int, redo_bytes: int):
        self.index = RadixTree()
        self.lru = LRUList()
        self.redo = CircularWAL(redo_bytes)          # NVMM-resident
        self.pool: dict[int, bytearray] = {}         # frame_id → NVMM page
        self.headers: dict[int, tuple[int, bool]] = {}  # persistent (pno, dirty)
        self.free_frames = list(range(frames - 1, -1, -1))
        self.max_frames = frames


class NVPages:
    def __init__(self, nvmm_bytes: int, disk: Disk, clock: SimClock, *,
                 redo_log_bytes: Optional[int] = None, o_direct: bool = False,
                 shards: int = 1):
        self.disk = disk
        self.clock = clock
        self.o_direct = o_direct
        self.num_shards = shards
        if redo_log_bytes is None:
            # almost all NVMM goes to pages (paper §II Discussion); the redo
            # log only needs to cover in-flight writes
            redo_log_bytes = max(min(8 << 20, nvmm_bytes // 16), 16 << 10)
        frames_total = max((nvmm_bytes - shards * redo_log_bytes)
                           // PAGE_SIZE, shards)
        self.shards = [
            _Shard(frames_total // shards, redo_log_bytes)
            for _ in range(shards)]
        # counters for the paper's write-amplification analysis
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "nvmm_page_writes": 0, "redo_writes": 0}

    # ------------------------------------------------------------------ util
    def _shard(self, pno: int) -> _Shard:
        return self.shards[pno % self.num_shards]

    def is_resident(self, pno: int) -> bool:
        """True if ``pno`` currently occupies an NVMM frame."""
        return self._shard(pno).index.lookup(pno) is not None

    def nvmm_capacity_bytes(self) -> int:
        """NVMM actually provisioned: frame pools + redo logs (may round
        below the requested budget)."""
        return sum(sh.max_frames * PAGE_SIZE + sh.redo.capacity
                   for sh in self.shards)

    def nvmm_used_bytes(self) -> int:
        """Live NVMM footprint: occupied frames + un-reclaimed redo bytes."""
        return sum(len(sh.pool) * PAGE_SIZE + sh.redo.used
                   for sh in self.shards)

    def _evict_one(self, sh: _Shard) -> None:
        victim = sh.lru.pop_lru()
        assert victim is not None, "evicting from empty LRU"
        frame: Frame = sh.index.lookup(victim)
        if frame.dirty:
            data = bytes(sh.pool[frame.frame_id])
            self.clock.charge(NVMM, "read", PAGE_SIZE)   # read page out of NVMM
            if self.o_direct:
                self.disk.write_page_direct(victim, data)
            else:
                # durable writeback keeping a clean LPC copy (no per-evict
                # fsync barrier — the page is persisted by the write itself)
                self.disk.write_page_through(victim, data)
        sh.index.delete(victim)
        sh.headers.pop(frame.frame_id, None)
        sh.pool.pop(frame.frame_id, None)
        sh.free_frames.append(frame.frame_id)
        self.stats["evictions"] += 1

    def _get_frame(self, pno: int, *, load: bool) -> Frame:
        """Return the frame for pno, faulting it in (copy to NVMM) on miss."""
        sh = self._shard(pno)
        frame: Optional[Frame] = sh.index.lookup(pno)
        if frame is not None:
            self.stats["hits"] += 1
            sh.lru.touch(pno)
            return frame
        self.stats["misses"] += 1
        if not sh.free_frames:
            self._evict_one(sh)
        fid = sh.free_frames.pop()
        if load:
            data = self.disk.read_page(pno, bypass_lpc=self.o_direct)
            # the miss cost the paper highlights: copy page into NVMM
            self.clock.charge(NVMM, "write", PAGE_SIZE)
            self.stats["nvmm_page_writes"] += 1
        else:
            data = _ZERO_PAGE   # full overwrite: no copy, the write follows
        sh.pool[fid] = bytearray(data)
        frame = Frame(fid, pno, dirty=False)
        sh.headers[fid] = (pno, False)
        sh.index.insert(pno, frame)
        sh.lru.touch(pno)
        return frame

    # ------------------------------------------------------------------- IO
    def pwrite(self, offset: int, data: bytes) -> int:
        """Durable as soon as this returns (redo record persisted)."""
        for pos, pno, in_page, n in iter_page_chunks(offset, len(data)):
            chunk = data[pos:pos + n]
            sh = self._shard(pno)
            # 1. redo log append (sequential NVMM write)
            rec_size = sh.redo.record_size(n)
            if rec_size > sh.redo.free:
                # redo entries are applied immediately below, so the log can
                # always be reclaimed wholesale
                sh.redo.reclaim_to(sh.redo.head, sh.redo.next_seqno)
            sh.redo.append(offset + pos, chunk)
            self.clock.charge(NVMM, "write", rec_size, random_access=False)
            self.stats["redo_writes"] += 1
            # 2. apply into the NVMM page (second write — the 2× the paper
            #    predicts for pure-write workloads)
            full_overwrite = (in_page == 0 and n == PAGE_SIZE)
            frame = self._get_frame(pno, load=not full_overwrite)
            sh.pool[frame.frame_id][in_page:in_page + n] = chunk
            self.clock.charge(NVMM, "write", n)
            self.stats["nvmm_page_writes"] += 1
            if not frame.dirty:
                frame.dirty = True
                sh.headers[frame.frame_id] = (pno, True)
            # 3. applied → reclaim the redo record
            sh.redo.reclaim_to(sh.redo.head, sh.redo.next_seqno)
        return len(data)

    def pread(self, offset: int, n: int) -> bytes:
        out = bytearray()
        for _, pno, in_page, take in iter_page_chunks(offset, n):
            sh = self._shard(pno)
            frame: Optional[Frame] = sh.index.lookup(pno)
            if frame is None:
                frame = self._get_frame(pno, load=True)
            else:
                self.stats["hits"] += 1
                sh.lru.touch(pno)
            # reads come from NVMM — the paper's fundamental flaw: NVMM read
            # bandwidth ≪ DRAM read bandwidth
            self.clock.charge(NVMM, "read", take)
            out += sh.pool[frame.frame_id][in_page:in_page + take]
        return bytes(out)

    def fsync(self) -> None:
        """No-op: pwrite is already durable at return (paper §III)."""

    # ------------------------------------------------------- crash / recovery
    def flush_all(self) -> None:
        for sh in self.shards:
            for pno, frame in list(sh.index.items()):
                if frame.dirty:
                    data = bytes(sh.pool[frame.frame_id])
                    self.clock.charge(NVMM, "read", PAGE_SIZE)
                    self.disk.write_page_lpc(pno, data)
                    frame.dirty = False
                    sh.headers[frame.frame_id] = (pno, False)
        self.disk.fsync()

    def crash(self) -> None:
        """Volatile state (radix index, LRU) is lost; NVMM pool/headers/redo
        and the disk survive."""
        for sh in self.shards:
            sh.index = RadixTree()
            sh.lru = LRUList()
        self.disk.crash()

    def remount(self) -> None:
        """Rebuild the volatile index/LRU/free-list from the persistent
        NVMM frame headers (the cheap half of recovery: no replay, no
        flush — what a clean image still needs after power loss)."""
        for sh in self.shards:
            sh.free_frames = list(
                set(range(sh.max_frames)) - set(sh.headers.keys()))
            for fid, (pno, dirty) in sh.headers.items():
                self.clock.charge(NVMM, "read", 16)     # header scan
                sh.index.insert(pno, Frame(fid, pno, dirty))
                sh.lru.touch(pno)

    def recover(self) -> None:
        """Rebuild the index from NVMM frame headers, replay redo-log
        remnants, then flush every pending modification to disk (paper §II)."""
        self.remount()
        for sh in self.shards:
            for _, rec in sh.redo.iter_from(sh.redo.tail):
                pno = rec.offset // PAGE_SIZE
                in_page = rec.offset % PAGE_SIZE
                frame = sh.index.lookup(pno)
                if frame is None:
                    frame = self._get_frame(pno, load=True)
                self.clock.charge(NVMM, "read", rec.size)
                self.clock.charge(NVMM, "write", len(rec.payload))
                sh.pool[frame.frame_id][in_page:in_page + len(rec.payload)] = \
                    rec.payload
                frame.dirty = True
                sh.headers[frame.frame_id] = (pno, True)
            sh.redo.reclaim_to(sh.redo.head, sh.redo.next_seqno)
        self.flush_all()
