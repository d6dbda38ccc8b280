"""Quickstart on the PyTorch port: every registered cache engine behind one
POSIX-like API — the paper's two designs, the psync references, and the
hybrid — exercised through the same write/read/crash/recover script, with
a per-engine table from the unified ``stats()`` protocol. The twin of
``examples/quickstart.py`` on ``repro_torch.core`` (host code: the file
system tier runs on the CPU in both packages).

    PYTHONPATH=src python examples/quickstart_torch.py
"""
from repro_torch.core import NVCacheFS, PAGE_SIZE
from repro_torch.core.engines import EngineSpec, list_engines

# engine-specific counters worth surfacing per design (all come out of the
# same stats() dict — the protocol is uniform, the designs are not)
_HIGHLIGHTS = ("log_appends", "nvmm_page_writes", "evictions", "dram_hits",
               "routed_log", "routed_pages", "lpc_writes", "fsyncs")


def drive(engine: str) -> dict:
    """One write/read-hot/crash/recover cycle; returns a summary row."""
    fs = NVCacheFS(EngineSpec(engine=engine, nvmm_bytes=8 << 20,
                              dram_cache_bytes=2 << 20))
    fd = fs.open("/demo/file")

    # write 2 MiB full pages + a scatter of small records, read it back hot
    blob = b"\xAB" * PAGE_SIZE
    for off in range(0, 2 << 20, PAGE_SIZE):
        fs.pwrite(fd, blob, off)
    fs.pwritev(fd, [((2 << 20) + 256 * i, b"rec%03d" % i)
                    for i in range(64)])
    for _ in range(2):
        for off in range(0, 2 << 20, PAGE_SIZE):
            fs.pread(fd, PAGE_SIZE, off)
    fs.fsync(fd)

    # crash and recover — fsync'd data must survive on every engine
    fs.crash()
    rec_t = fs.recover()
    fd = fs.open("/demo/file")
    survived = fs.pread(fd, 4, 0) == b"\xAB" * 4
    s = fs.stats()
    s.update(engine=engine, recovery_ms=rec_t * 1e3, survived=survived)
    return s


def main():
    print("=== NVMM cache designs: logging vs paging (Dulong et al. 2023)\n")
    rows = [drive(engine) for engine in list_engines()]
    print(f"{'engine':12s} {'sim_ms':>9s} {'recov_ms':>9s} {'fsyncd_ok':>9s} "
          f"{'nvmm_used':>10s}  notable counters")
    for s in rows:
        notable = "  ".join(f"{k}={s[k]}" for k in _HIGHLIGHTS if k in s)
        print(f"{s['engine']:12s} {s['sim_time_s']*1e3:9.2f} "
              f"{s['recovery_ms']:9.2f} {str(s['survived']):>9s} "
              f"{s['nvmm_used_bytes']:>10d}  {notable}")
    print("\npsync would lose un-fsync'd data — the paper's motivation: the "
          "NVMM designs give persistence at pwrite-return, at very "
          "different costs; nvhybrid routes each write to whichever design "
          "wins it (see benchmarks/fio_bench.py for the full grid).")


if __name__ == "__main__":
    main()
