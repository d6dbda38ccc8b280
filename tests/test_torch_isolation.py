"""The port stands alone: serving through it — dense, int8 and MLA cache
families — loads neither JAX nor any module of the JAX package."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    for arch, kd in (("internlm2-1.8b-smoke", "native"),
                     ("internlm2-1.8b-smoke", "int8"),
                     ("deepseek-v2-236b-noexperts-smoke", "native")):
        cfg = get_config(arch)
        model = LM(cfg, device="cpu", kv_cache_dtype=kd).init(
            torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(0, 512, 6,
                                                   dtype=np.int32),
                        max_new=3) for i in range(2)]
        eng = ServingEngine(model, ServeConfig(max_len=16, page_tokens=4),
                            device="cpu")
        assert eng.desc.family == {"native": "mla" if cfg.mla else "dense",
                                   "int8": "int8"}[kd]
        eng.generate(reqs)
        assert all(len(r.generated) == 3 for r in reqs)
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "repro" or m.startswith("repro."))
    print("LOADED:", bad)
    sys.exit(1 if bad else 0)
""")


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED: []" in proc.stdout
