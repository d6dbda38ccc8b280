"""Serving the port's new dense configs against the JAX package's.

``gemma-7b-smoke``, ``minicpm-2b-smoke`` and ``starcoder2-15b-smoke`` on
the pool and through the dense mirror (``log``, ``kvhybrid``), each fused
and unfused: the port gives JAX's tokens and JAX's whole ``stats()`` dict
for the same schedule (``tests/torch_serving_pairs.py``: the JAX
``LM.init`` weights carried across, fp32), and the sequential
reference's tokens.
"""
import pytest

from torch_serving_pairs import SERVE_IDS, SERVE_RUNS, serve_arch, serve_pair
from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)

DENSE_SMOKE = ("gemma-7b-smoke", "minicpm-2b-smoke", "starcoder2-15b-smoke")


@pytest.mark.parametrize("name,fuse", SERVE_RUNS, ids=SERVE_IDS)
@pytest.mark.parametrize("arch", DENSE_SMOKE)
def test_dense_config_serving_matches_jax(arch, name, fuse):
    pair, tt = serve_pair(arch, name, fuse)
    assert tt == serve_arch("torch", pair, "log", True, seq=True)[0]
