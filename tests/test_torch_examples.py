"""The examples' twins on the CPU: ``examples/quickstart_torch.py`` and
``examples/crash_recovery_demo_torch.py`` print what the reference's
``quickstart.py`` and ``crash_recovery_demo.py`` print (host code in both
packages: the same engines, the same simulated clock; the crash demo's
section title drops the reference's design-doc reference), and
``examples/serve_kv_offload_torch.py --device cpu`` passes its asserts."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"


def _run(name, *argv):
    proc = subprocess.run([sys.executable, str(EXAMPLES / name), *argv],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                                   JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout.splitlines()


@pytest.mark.parametrize("twin,reference", [
    ("quickstart_torch.py", "quickstart.py"),
    ("crash_recovery_demo_torch.py", "crash_recovery_demo.py")])
def test_twin_prints_what_the_reference_prints(twin, reference):
    got, want = _run(twin), _run(reference)
    want = [line.replace("DESIGN.md §5: ", "") for line in want]
    assert got == want


def test_serving_twin_passes_its_asserts_on_the_cpu():
    out = "\n".join(_run("serve_kv_offload_torch.py", "--device", "cpu"))
    assert "family=int8" in out and "family=ssm" in out
    assert "recovered engine finished all rows" in out
    assert "all 3 registered KV designs" in out
    assert "design=paged    path=pooled mirror_d2h_bytes=       0" in out
