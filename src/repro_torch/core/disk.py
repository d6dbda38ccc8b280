"""Backing store: SSD contents + a Linux-page-cache (LPC) model in DRAM.

Functionally real: SSD content is a dict of 4 KiB pages; the LPC is a
write-back DRAM cache over it. The psync FIO baseline in the paper *is* the
LPC — no persistence until fsync. ``crash()`` drops the LPC (volatile),
keeping only fsync'd SSD content.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.clock import SimClock
from repro_torch.core.lru import LRUList
from repro_torch.roofline.hw import DRAM, SSD, SSD_FSYNC_LATENCY

PAGE_SIZE = 4096
_ZERO_PAGE = bytes(PAGE_SIZE)


def iter_page_chunks(offset: int, length: int):
    """Yield ``(pos, pno, in_page, n)`` page-granular chunks covering the
    byte range ``[offset, offset+length)`` — the splitting every engine and
    the LPC helpers share: ``pos`` is the chunk start relative to the range,
    ``pno`` the page number, ``in_page`` the offset within it, ``n`` the
    chunk length (a full page iff ``in_page == 0 and n == PAGE_SIZE``)."""
    pos = 0
    while pos < length:
        pno, in_page = divmod(offset + pos, PAGE_SIZE)
        n = min(PAGE_SIZE - in_page, length - pos)
        yield pos, pno, in_page, n
        pos += n


class Disk:
    def __init__(self, clock: SimClock, lpc_capacity_pages: Optional[int] = None):
        self.clock = clock
        self.ssd: dict[int, bytes] = {}
        self.lpc: dict[int, bytearray] = {}
        self.lpc_dirty: set[int] = set()
        self.lpc_lru = LRUList()
        self.lpc_capacity = lpc_capacity_pages   # None = unbounded

    # -- internals ------------------------------------------------------------
    def _lpc_insert(self, pno: int, data: bytearray, dirty: bool) -> None:
        if (self.lpc_capacity is not None and pno not in self.lpc
                and len(self.lpc) >= self.lpc_capacity):
            victim = None
            for cand in self.lpc_lru.lru_order():
                victim = cand
                break
            if victim is not None:
                if victim in self.lpc_dirty:
                    self._writeback(victim)
                self.lpc.pop(victim, None)
                self.lpc_lru.remove(victim)
        self.lpc[pno] = data
        self.lpc_lru.touch(pno)
        if dirty:
            self.lpc_dirty.add(pno)

    def _writeback(self, pno: int) -> None:
        self.clock.charge(SSD, "write", PAGE_SIZE, random_access=True)
        self.ssd[pno] = bytes(self.lpc[pno])
        self.lpc_dirty.discard(pno)

    # -- public ----------------------------------------------------------------
    def read_page(self, pno: int, bypass_lpc: bool = False) -> bytes:
        """Read a page; charges DRAM (LPC hit) or SSD (miss) time."""
        if not bypass_lpc and pno in self.lpc:
            self.clock.charge(DRAM, "read", PAGE_SIZE)
            self.lpc_lru.touch(pno)
            return bytes(self.lpc[pno])
        self.clock.charge(SSD, "read", PAGE_SIZE, random_access=True)
        data = self.ssd.get(pno, _ZERO_PAGE)
        if not bypass_lpc:
            self.clock.charge(DRAM, "write", PAGE_SIZE)
            self._lpc_insert(pno, bytearray(data), dirty=False)
        return bytes(data)

    def write_page_lpc(self, pno: int, data: bytes) -> None:
        """Buffered write into the LPC (no persistence until fsync)."""
        self.clock.charge(DRAM, "write", len(data))
        page = self.lpc.get(pno)
        if page is None:
            if len(data) < PAGE_SIZE and pno in self.ssd:
                # read-modify-write of a partially-overwritten page
                self.clock.charge(SSD, "read", PAGE_SIZE, random_access=True)
                page = bytearray(self.ssd[pno])
            else:
                page = bytearray(PAGE_SIZE)
            self._lpc_insert(pno, page, dirty=True)
        else:
            self.lpc_lru.touch(pno)
            self.lpc_dirty.add(pno)
        page[:len(data)] = data

    def write_page_through(self, pno: int, data: bytes) -> None:
        """Durable writeback that keeps a clean LPC copy (cache eviction
        path: the page must be durable before its NVMM copy is dropped, but
        readers should still find it at DRAM speed)."""
        assert len(data) == PAGE_SIZE
        self.clock.charge(SSD, "write", PAGE_SIZE, random_access=True)
        self.ssd[pno] = bytes(data)
        self.clock.charge(DRAM, "write", PAGE_SIZE)
        self._lpc_insert(pno, bytearray(data), dirty=False)

    def write_page_direct(self, pno: int, data: bytes) -> None:
        """O_DIRECT-style write: straight to SSD, invalidating the LPC copy."""
        assert len(data) == PAGE_SIZE
        self.clock.charge(SSD, "write", PAGE_SIZE, random_access=True)
        self.ssd[pno] = bytes(data)
        self.lpc.pop(pno, None)
        self.lpc_dirty.discard(pno)
        self.lpc_lru.remove(pno)

    def write_bytes(self, offset: int, data: bytes) -> int:
        """Byte-granular buffered write through the LPC.

        The page-granular read-modify-write loop shared by every
        LPC-backed write path (the paper's psync reference): full-page
        aligned chunks go straight in; partial chunks patch the page.
        """
        for pos, pno, in_page, n in iter_page_chunks(offset, len(data)):
            if in_page == 0 and n == PAGE_SIZE:
                self.write_page_lpc(pno, data[pos:pos + n])
            else:
                page = bytearray(self.read_page(pno))
                page[in_page:in_page + n] = data[pos:pos + n]
                self.write_page_lpc(pno, bytes(page))
        return len(data)

    def read_bytes(self, offset: int, n: int) -> bytes:
        """Byte-granular read through the LPC (page-chunked)."""
        out = bytearray()
        for _, pno, in_page, take in iter_page_chunks(offset, n):
            out += self.read_page(pno)[in_page:in_page + take]
        return bytes(out)

    def _flush_dirty(self, pnos: list[int]) -> None:
        """Write back the given dirty pages + one fsync barrier."""
        for pno in pnos:
            self.clock.charge(SSD, "write", PAGE_SIZE, random_access=True)
            self.ssd[pno] = bytes(self.lpc[pno])
            self.lpc_dirty.discard(pno)
        self.clock.advance(SSD_FSYNC_LATENCY)

    def fsync(self) -> None:
        """Flush all dirty LPC pages to SSD + barrier latency."""
        self._flush_dirty(sorted(self.lpc_dirty))

    def fsync_range(self, lo_pno: int, hi_pno: int) -> None:
        """Flush only dirty LPC pages with ``lo_pno <= pno < hi_pno``
        (per-file sync: other files' un-synced pages stay volatile). A
        clean range is free — closing a read-only file must not charge a
        barrier (full ``fsync()`` keeps the always-barrier model)."""
        pnos = sorted(p for p in self.lpc_dirty if lo_pno <= p < hi_pno)
        if pnos:
            self._flush_dirty(pnos)

    # -- crash semantics ---------------------------------------------------------
    def crash(self) -> None:
        """Power loss: the LPC (volatile DRAM) is gone; SSD content survives."""
        self.lpc.clear()
        self.lpc_dirty.clear()
        self.lpc_lru = LRUList()

    # -- silent ops (background drainer: time is charged analytically) -----------
    def apply_silent(self, pno: int, offset_in_page: int, payload: bytes) -> None:
        page = bytearray(self.ssd.get(pno, _ZERO_PAGE))
        page[offset_in_page:offset_in_page + len(payload)] = payload
        self.ssd[pno] = bytes(page)
        # the drainer writes *through the LPC* (paper §II: NVLog uses the LPC
        # as a read extension of its DRAM cache) — land a clean copy there
        lpc_page = self.lpc.get(pno)
        if lpc_page is not None:
            lpc_page[offset_in_page:offset_in_page + len(payload)] = payload
        else:
            self._lpc_insert(pno, bytearray(page), dirty=False)
