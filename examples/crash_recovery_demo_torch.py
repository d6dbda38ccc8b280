"""Fault-tolerance walkthrough on the PyTorch port: the paper's crash-flag
protocol end-to-end at FIO level, plus elastic re-meshing. The twin of
``examples/crash_recovery_demo.py`` on ``repro_torch`` (host code in both
packages).

    PYTHONPATH=src python examples/crash_recovery_demo_torch.py
"""
from repro_torch.core import NVCacheFS
from repro_torch.training.elastic import (MeshPlan, StragglerPolicy,
                                          replan_mesh)


def io_level():
    print("--- paper §II: NVMM flag + recovery (IO level)")
    fs = NVCacheFS("nvlog", nvmm_bytes=4 << 20, dram_cache_bytes=1 << 20)
    fd = fs.open("/db/wal")
    for i in range(200):
        fs.pwrite(fd, f"record-{i:04d}".encode().ljust(64, b"."), i * 64)
    print(f"    nvmm flag = {fs.nvmm_flag} (loaded)")
    fs.crash()
    print("    *** power loss: DRAM cache + LPC gone; NVMM log survives")
    t = fs.recover()
    fd = fs.open("/db/wal")
    rec = fs.pread(fd, 64, 199 * 64)
    print(f"    recovered in {t*1e3:.2f}ms (sim); last record: "
          f"{rec[:11].decode()} ✓")


def elastic_level():
    print("--- elastic re-mesh + straggler policy")
    plan = MeshPlan(data=16, model=16)
    new = replan_mesh(plan, healthy_devices=224, global_batch=256)
    print(f"    lost 32 chips: {plan.data}x{plan.model} → "
          f"{new.data}x{new.model} (TP intact, batch divides)")
    pol = StragglerPolicy()
    for step in range(8):
        for h in ("h0", "h1", "h2", "h3"):
            pol.observe(h, 4.0 if h == "h3" else 1.0)
    print(f"    stragglers detected: {pol.stragglers()}; shards reassigned: "
          f"{pol.reassign_shards(8, ['h0','h1','h2','h3'])}")
    print("    (deterministic data pipeline ⇒ reassignment moves no data)")


if __name__ == "__main__":
    io_level()
    elastic_level()
