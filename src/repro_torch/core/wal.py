"""Write-ahead log with CRC32-framed records over a persistent byte region.

The port's copy of the JAX package's ``CircularWAL``.

Replaces the paper's 8-byte-atomic Optane persist with torn-write detection:
a record is durable iff its CRC verifies on recovery scan. The log is
circular; space is reclaimed when the drainer (or page-flush, for NVPages'
redo log) confirms entries applied.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, Optional

_MAGIC = 0x4E564C47  # 'NVLG'
_HEADER = struct.Struct("<IQQIII")  # magic, seqno, offset, length, crc, _pad
HEADER_SIZE = _HEADER.size


@dataclass
class LogRecord:
    seqno: int
    offset: int          # byte offset in the backing file
    payload: bytes

    @property
    def size(self) -> int:
        return HEADER_SIZE + len(self.payload)


class CircularWAL:
    """A circular write-ahead log in a persistent byte region.

    The region itself (a bytearray) survives "crashes" (the harness keeps it);
    head/tail indices are volatile and reconstructed by ``recover_scan``.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.buf = bytearray(capacity)
        self.head = 0            # next write position (logical, monotonic)
        self.tail = 0            # oldest un-reclaimed byte (logical)
        self.next_seqno = 1
        # persistent superblock mirror (kept alongside the region)
        self._persist_tail = 0
        self._persist_tail_seq = 1   # seqno of the first un-reclaimed record

    # -- geometry -----------------------------------------------------------
    @property
    def used(self) -> int:
        return self.head - self.tail

    @property
    def free(self) -> int:
        return self.capacity - self.used

    def _write_at(self, logical: int, data: bytes) -> None:
        pos = logical % self.capacity
        end = pos + len(data)
        if end <= self.capacity:
            self.buf[pos:end] = data
        else:
            first = self.capacity - pos
            self.buf[pos:] = data[:first]
            self.buf[:end - self.capacity] = data[first:]

    def _read_at(self, logical: int, n: int) -> bytes:
        pos = logical % self.capacity
        end = pos + n
        if end <= self.capacity:
            return bytes(self.buf[pos:end])
        first = self.capacity - pos
        return bytes(self.buf[pos:]) + bytes(self.buf[:end - self.capacity])

    # -- append / reclaim ----------------------------------------------------
    def record_size(self, payload_len: int) -> int:
        return HEADER_SIZE + payload_len

    def append(self, offset: int, payload: bytes) -> LogRecord:
        size = self.record_size(len(payload))
        if size > self.free:
            raise BufferError("log full")
        seqno = self.next_seqno
        crc = zlib.crc32(payload)
        hdr = _HEADER.pack(_MAGIC, seqno, offset, len(payload), crc, 0)
        self._write_at(self.head, hdr + payload)
        self.head += size
        self.next_seqno += 1
        return LogRecord(seqno, offset, payload)

    def reclaim_to(self, logical: int, next_seqno: int) -> None:
        """Mark everything before ``logical`` as drained/applied.

        ``next_seqno`` is the seqno of the first record at/after ``logical``
        (guards recovery against stale same-CRC records from previous laps).
        """
        assert self.tail <= logical <= self.head
        self.tail = logical
        self._persist_tail = logical
        self._persist_tail_seq = next_seqno

    # -- iteration / recovery -------------------------------------------------
    def iter_from(self, logical: int) -> Iterator[tuple[int, LogRecord]]:
        """Yield (record_start_logical, record) from ``logical`` to head."""
        pos = logical
        while pos < self.head:
            hdr = self._read_at(pos, HEADER_SIZE)
            magic, seqno, offset, length, crc, _ = _HEADER.unpack(hdr)
            if magic != _MAGIC:
                return
            payload = self._read_at(pos + HEADER_SIZE, length)
            if zlib.crc32(payload) != crc:
                return                      # torn write — stop
            yield pos, LogRecord(seqno, offset, payload)
            pos += HEADER_SIZE + length

    def recover_scan(self) -> list[LogRecord]:
        """Post-crash: rebuild head from the persistent tail, return records.

        Walks records from the last persisted tail; stops at the first corrupt
        or out-of-sequence header (torn tail). Restores head/next_seqno.
        """
        self.tail = self._persist_tail
        records = []
        pos = self.tail
        last_seq = None
        while True:
            if pos + HEADER_SIZE > self.tail + self.capacity:
                break
            hdr = self._read_at(pos, HEADER_SIZE)
            magic, seqno, offset, length, crc, _ = _HEADER.unpack(hdr)
            if magic != _MAGIC or length > self.capacity:
                break
            expect = self._persist_tail_seq if last_seq is None else last_seq + 1
            if seqno != expect:
                break
            payload = self._read_at(pos + HEADER_SIZE, length)
            if zlib.crc32(payload) != crc:
                break
            records.append(LogRecord(seqno, offset, payload))
            last_seq = seqno
            pos += HEADER_SIZE + length
        self.head = pos
        self.next_seqno = (last_seq + 1) if last_seq is not None \
            else self._persist_tail_seq
        return records
