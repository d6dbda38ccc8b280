"""Serving the port's MoE configs against the JAX package's at no-drop
capacity (``capacity_factor = num_experts``).

The runs of ``test_torch_moe_serving.py``: the port gives JAX's tokens
and JAX's whole ``stats()`` dict on the pool and through the dense mirror
(``log``, ``kvhybrid``), each fused and unfused. With no token dropped
the tokens no longer depend on the batch: they also equal the
sequential reference's.
"""
import pytest

from repro_torch.configs import get_config

from torch_serving_pairs import SERVE_IDS, SERVE_RUNS, serve_arch, serve_pair
from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)

MOE_ARCHS = ("deepseek-v2-236b-smoke", "arctic-480b-smoke")


@pytest.mark.parametrize("name,fuse", SERVE_RUNS, ids=SERVE_IDS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_no_drop_serving_matches_jax_and_sequential(arch, name, fuse):
    pair, tt = serve_pair(arch, name, fuse,
                          float(get_config(arch).moe.num_experts))
    assert tt == serve_arch("torch", pair, "log", True, seq=True)[0]
