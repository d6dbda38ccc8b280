"""``chip_smoke.py``'s own contract, checkable without a card: every kernel
row names the TPU kernel it replaces by the line of its ``pl.pallas_call``
and the CUDA source that replaces it, and without a GPU the script exits
non-zero and prints no result."""
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("name", sorted(chip_smoke.KERNELS))
def test_kernel_rows_name_the_pallas_call_and_source(name):
    replaces, source = chip_smoke.KERNELS[name]
    path, line = replaces.rsplit(":", 1)
    text = (ROOT / path).read_text().splitlines()
    assert "pl.pallas_call(" in text[int(line) - 1], replaces
    assert (ROOT / source).is_file(), source


def test_refuses_without_a_gpu(tmp_path):
    """Here torch sees no GPU: exit 2, no result line — from the checkout
    and from a directory holding only the script."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script would run in full")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True, timeout=120,
                              cwd=script.parent)
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout


WORKLOADS = [wl.name for wl in chip_smoke.all_workloads(1 << 20, 1 << 20)]


@pytest.mark.parametrize("name", WORKLOADS)
def test_fio_copy_draws_the_reference_ops(name):
    """The script's copy of the fio mix (``benchmarks/common.py``, which
    the script may not import) draws the same offsets and read flags as
    the reference for each workload, at two seeds."""
    import numpy as np
    from benchmarks import common
    assert chip_smoke.MIXES == common.MIXES
    for seed in (0, 3):
        wl = next(w for w in chip_smoke.all_workloads(8 << 20, 2 << 20,
                                                      seed) if w.name == name)
        ref = next(w for w in common.all_workloads(8 << 20, 2 << 20, seed)
                   if w.name == name)
        assert (wl.read_frac, wl.zipf, wl.n_ops, wl.block) == (
            ref.read_frac, ref.zipf, ref.n_ops, ref.block)
        offsets, is_read = chip_smoke.fio_ops(wl)
        rng = np.random.default_rng(ref.seed)
        want = common.gen_offsets(ref, rng)
        np.testing.assert_array_equal(offsets, want)
        np.testing.assert_array_equal(is_read,
                                      rng.random(ref.n_ops) < ref.read_frac)


def test_peak_rss_sees_a_block_and_not_what_came_before():
    """``PeakRss`` reads the peak inside its block: 256 MiB held there
    shows, and a block after it is freed does not carry that peak on."""
    import gc
    with chip_smoke.PeakRss(every=0.005) as base:
        pass
    with chip_smoke.PeakRss(every=0.005) as held:
        buf = bytearray(256 << 20)
        buf[::4096] = b"\x01" * len(buf[::4096])
        time.sleep(0.05)
        del buf
        gc.collect()
    with chip_smoke.PeakRss(every=0.005) as after:
        pass
    assert held.gib >= base.gib + 0.2
    assert after.gib < held.gib - 0.2


def test_script_imports_neither_benchmarks_nor_the_jax_package():
    text = (ROOT / "chip_smoke.py").read_text()
    for bad in ("import benchmarks", "from benchmarks", "import jax",
                "from jax", "import repro\n", "from repro.", "import repro."):
        assert bad not in text, bad


def test_kernel_rows_cover_every_pallas_call_once():
    """One row for each ``pl.pallas_call`` of the JAX package, no more:
    the file-system tier adds no kernel."""
    sites = set()
    for path in sorted((ROOT / "src" / "repro" / "kernels").rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if "pl.pallas_call(" in line:
                sites.add(f"{path.relative_to(ROOT)}:{i}")
    rows = [replaces for replaces, _ in chip_smoke.KERNELS.values()]
    assert len(rows) == len(set(rows)) == len(sites) == 10
    assert set(rows) == sites
