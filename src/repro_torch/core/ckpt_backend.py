"""Checkpoint backends over the paper's two cache designs.

Both write through the same :class:`repro_torch.core.NVCacheFS` surface —
the design switch is literally the engine choice, as in the paper:

* ``PagedCheckpointBackend``  (engine=nvpages): full-snapshot, page-granular.
  Every ``save`` writes the complete state at fixed offsets.
* ``LogCheckpointBackend``    (engine=nvlog): incremental. Each ``save``
  appends only the shards that changed (delta records); a full snapshot is
  cut every ``snapshot_every`` saves; restore = snapshot + replay.

The manifest (name → offset/size/step) is persisted as a JSON header page so
restore works from a recovered image.
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.core.api import NVCacheFS
from repro_torch.core.disk import PAGE_SIZE

_HEADER_BYTES = 1 << 20           # manifest region
_ALIGN = PAGE_SIZE


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class _Base:
    def __init__(self, fs: NVCacheFS, path: str = "/ckpt/state"):
        self.fs = fs
        self.fd = fs.open(path)
        self.manifest: dict = {"entries": {}, "step": -1, "next_off": _HEADER_BYTES}

    # -- manifest persistence -------------------------------------------------
    def _write_manifest(self) -> None:
        blob = json.dumps(self.manifest).encode()
        assert len(blob) + 8 <= _HEADER_BYTES, "manifest overflow"
        self.fs.pwrite(self.fd, len(blob).to_bytes(8, "little") + blob, 0)

    def _read_manifest(self) -> dict:
        n = int.from_bytes(self.fs.pread(self.fd, 8, 0), "little")
        if n == 0:
            return {"entries": {}, "step": -1, "next_off": _HEADER_BYTES}
        return json.loads(self.fs.pread(self.fd, n, 8))

    def _alloc(self, name: str, size: int) -> int:
        ent = self.manifest["entries"].get(name)
        if ent is not None and ent["size"] >= size:
            return ent["off"]
        off = self.manifest["next_off"]
        self.manifest["next_off"] = off + _align(size)
        return off


class PagedCheckpointBackend(_Base):
    """Full snapshot every save (the paging design's natural mode)."""

    def save(self, step: int, state: dict[str, bytes]) -> float:
        t0 = self.fs.clock.now
        iov = []
        for name, blob in state.items():
            off = self._alloc(name, len(blob))
            iov.append((off, blob))
            self.manifest["entries"][name] = {
                "off": off, "size": len(blob), "step": step}
        self.fs.pwritev(self.fd, iov)
        self.manifest["step"] = step
        self._write_manifest()
        self.fs.fsync(self.fd)
        return self.fs.clock.now - t0

    def restore(self) -> tuple[int, dict[str, bytes]]:
        self.manifest = self._read_manifest()
        names = list(self.manifest["entries"])
        blobs = self.fs.preadv(self.fd, [
            (self.manifest["entries"][n]["off"],
             self.manifest["entries"][n]["size"]) for n in names])
        return self.manifest["step"], dict(zip(names, blobs))


class LogCheckpointBackend(_Base):
    """Incremental deltas + periodic snapshot (the logging design)."""

    def __init__(self, fs: NVCacheFS, path: str = "/ckpt/state",
                 snapshot_every: int = 8):
        super().__init__(fs, path)
        self.snapshot_every = snapshot_every
        self.manifest["deltas"] = []       # [(step, {name: [off, size]})]
        self._saves = 0

    def save(self, step: int, state: dict[str, bytes],
             changed: Optional[set] = None) -> float:
        """``changed``: names modified since last save (None = all)."""
        t0 = self.fs.clock.now
        self._saves += 1
        if self._saves % self.snapshot_every == 1 or "deltas" not in self.manifest:
            # cut a full snapshot; log restarts from here
            iov = []
            for name, blob in state.items():
                off = self._alloc(name, len(blob))
                iov.append((off, blob))
                self.manifest["entries"][name] = {
                    "off": off, "size": len(blob), "step": step}
            self.fs.pwritev(self.fd, iov)
            self.manifest["deltas"] = []
        else:
            names = changed if changed is not None else set(state)
            iov = []
            delta = {}
            for name in sorted(names):
                blob = state[name]
                off = self.manifest["next_off"]
                self.manifest["next_off"] = off + _align(len(blob))
                iov.append((off, blob))
                delta[name] = [off, len(blob)]
            self.fs.pwritev(self.fd, iov)
            self.manifest["deltas"].append([step, delta])
        self.manifest["step"] = step
        self._write_manifest()
        self.fs.fsync(self.fd)
        return self.fs.clock.now - t0

    def restore(self) -> tuple[int, dict[str, bytes]]:
        self.manifest = self._read_manifest()
        names = list(self.manifest["entries"])
        blobs = self.fs.preadv(self.fd, [
            (self.manifest["entries"][n]["off"],
             self.manifest["entries"][n]["size"]) for n in names])
        out = dict(zip(names, blobs))
        for step, delta in self.manifest.get("deltas", []):
            items = list(delta.items())
            blobs = self.fs.preadv(self.fd, [(off, size)
                                             for _, (off, size) in items])
            out.update({name: blob
                        for (name, _), blob in zip(items, blobs)})
        return self.manifest["step"], out
