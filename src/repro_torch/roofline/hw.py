"""The card the roofline scores against (``Chip``, ``H100``), and the
storage-tier model of the simulated clock.

``H100`` is NVIDIA's H100 SXM5 data sheet (dense rates, no sparsity, at
the full 700 W power limit; NVLink 4 from the Hopper architecture white
paper): the roofline's compute, memory and collective terms and
``chip_smoke.py``'s bounds read it. A card set below 700 W runs slower
under load than these peaks.

The paper's tier model (host-side cache benchmarks) — calibrated from
Izraelevitz et al. [arXiv:1903.05714] Optane DCPMM measurements and vendor
specs for the paper's Supermicro testbed (Xeon Gold 6326, Optane v200,
512 GB NVMe SSD). Seconds per byte + per-op latency. These constants drive
simulated time only; they describe no GPU.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class Chip:
    name: str
    peak_flops_bf16: float     # FLOP/s, tensor cores, fp32 accumulation
    peak_flops_tf32: float     # FLOP/s, tensor cores
    peak_flops_fp32: float     # FLOP/s, CUDA cores
    hbm_bandwidth: float       # B/s
    hbm_bytes: int             # device memory
    nvlink_bandwidth: float    # B/s to the host's other cards, each way
    sms: int                   # streaming multiprocessors
    smem_per_sm: int           # bytes of shared memory (with L1) an SM


H100 = Chip(name="nvidia-h100-sxm5", peak_flops_bf16=989e12,
            peak_flops_tf32=495e12, peak_flops_fp32=67e12,
            hbm_bandwidth=3.35e12, hbm_bytes=80 * 10**9,
            nvlink_bandwidth=450e9, sms=132, smem_per_sm=228 * 1024)


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

SSD_FSYNC_LATENCY = 1e-3   # s per fsync barrier (paper §III: psync+fsync > 1 h)
