"""``chip_smoke.py``'s own contract, checkable without a card: every kernel
row names the TPU kernel it replaces by the line of its ``pl.pallas_call``
and the CUDA source that replaces it, and without a GPU the script exits
non-zero and prints no result."""
import subprocess
import sys
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
