"""The paper's fio grid (Figs. 3-4) on the port's ``NVCacheFS``, against
the reference's, at a 2 MiB file.

The reference's own fio runner (``benchmarks.fio_bench.run_grid`` over
``benchmarks.common.run_workload``, which lays the file out through
``fs.disk.ssd`` and warms ``fs.disk._lpc_insert``) runs unchanged on both
packages' ``NVCacheFS``: every cell's simulated seconds are equal, and so
are the paper-claim lists. ``chip_smoke.py``'s own copy of the runner
gives the same cells on the port.
"""
import sys
from pathlib import Path

import pytest

import benchmarks.fio_bench as fio_bench
from benchmarks.common import all_workloads

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

FILE_BYTES = 2 << 20
ENGINES = ("nvpages", "nvlog", "psync", "nvhybrid")
_GRIDS: dict = {}


def _port_fs(engine, nvmm, dram_cache):
    from repro_torch.core import EngineSpec, NVCacheFS
    return NVCacheFS(EngineSpec(engine=engine, nvmm_bytes=nvmm,
                                dram_cache_bytes=dram_cache))


def grid(pkg):
    """``run_grid`` at 2 MiB, one run, the fsync job included, on ``pkg``
    (``chip_smoke``: the script's copy on the port)."""
    if pkg not in _GRIDS:
        if pkg == "chip_smoke":
            _GRIDS[pkg] = chip_smoke.run_grid(FILE_BYTES)
        else:
            ref_fs = fio_bench.engine_fs
            if pkg == "repro_torch":
                fio_bench.engine_fs = _port_fs
            try:
                _GRIDS[pkg] = fio_bench.run_grid(FILE_BYTES, 1, ENGINES, True)
            finally:
                fio_bench.engine_fs = ref_fs
    return _GRIDS[pkg]


CELLS = [(fig, wl.name) for fig in ("fig3", "fig4")
         for wl in all_workloads(FILE_BYTES, FILE_BYTES)] + [
    ("fig3", "randw(1/8 size)")]


@pytest.mark.parametrize("fig,workload", CELLS,
                         ids=[f"{f}-{w}" for f, w in CELLS])
def test_cell_sim_time_equals_reference(fig, workload):
    def cells(pkg):
        return {r["engine"]: r["sim_time_s"] for r in grid(pkg)
                if (r["figure"], r["workload"]) == (fig, workload)}
    want = cells("repro")
    assert want and set(want) == (set(ENGINES) if "1/8" not in workload
                                  else {"psync_fsync"})
    assert cells("repro_torch") == want
    assert cells("chip_smoke") == want


def test_paper_claims_equal_reference():
    want = fio_bench.validate_paper_claims(grid("repro"))
    assert fio_bench.validate_paper_claims(grid("repro_torch")) == want
    assert chip_smoke.validate_paper_claims(grid("chip_smoke")) == want
    assert len(want) == 8


def test_grid_rows_are_the_reference_rows():
    keys = ("figure", "nvmm", "workload", "engine", "sim_time_s",
            "sim_time_std")
    want = grid("repro")
    assert grid("repro_torch") == want
    assert [{k: r[k] for k in keys} for r in grid("chip_smoke")] == want
