"""Storage-tier model of the simulated clock.

The paper's tier model (host-side cache benchmarks) — calibrated from
Izraelevitz et al. [arXiv:1903.05714] Optane DCPMM measurements and vendor
specs for the paper's Supermicro testbed (Xeon Gold 6326, Optane v200,
512 GB NVMe SSD). Seconds per byte + per-op latency. These constants drive
simulated time only; they describe no GPU.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class TierSpec:
    name: str
    read_bw: float          # B/s sequential
    write_bw: float         # B/s sequential
    rand_read_bw: float     # B/s at 4 KiB granularity
    rand_write_bw: float    # B/s at 4 KiB granularity
    read_latency: float     # s per operation
    write_latency: float    # s per operation


DRAM = TierSpec("dram", read_bw=100e9, write_bw=80e9,
                rand_read_bw=25e9, rand_write_bw=20e9,
                read_latency=90e-9, write_latency=90e-9)

# Optane v200 (2 interleaved 128 GiB modules): ~8.1/4.6 GB/s seq R/W per
# module pair region; random 4K ~2.5/1.0 GB/s; ~300 ns read latency.
NVMM = TierSpec("nvmm", read_bw=8.1e9, write_bw=4.6e9,
                rand_read_bw=2.5e9, rand_write_bw=1.0e9,
                read_latency=305e-9, write_latency=100e-9)

# Datacenter NVMe SSD: ~3.0/1.5 GB/s seq, 4K random ~500/300 MB/s,
# ~80 µs read latency, ~20 µs buffered write, ~1 ms fsync.
SSD = TierSpec("ssd", read_bw=3.0e9, write_bw=1.5e9,
               rand_read_bw=0.5e9, rand_write_bw=0.3e9,
               read_latency=80e-6, write_latency=20e-6)
