"""Serving the port's MoE configs against the JAX package's, at the
published capacity factor.

``deepseek-v2-236b-smoke`` (MLA attention, a dense first layer, shared
experts) and ``arctic-480b-smoke`` (GQA, a parallel dense residual) on
the pool and through the dense mirror (``log``, ``kvhybrid``), each fused
and unfused: the port gives JAX's tokens and JAX's whole ``stats()`` dict
for the same schedule (``tests/torch_serving_pairs.py``: the JAX
``LM.init`` weights carried across, fp32). At capacity factor 1.25 the
tokens may differ from the sequential reference's, in both packages
alike: capacity counts every token of a tick, padding included.
``test_torch_moe_nodrop.py`` serves the same at no-drop capacity.
"""
import pytest

from torch_serving_pairs import SERVE_IDS, SERVE_RUNS, serve_arch, serve_pair
from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)

MOE_ARCHS = ("deepseek-v2-236b-smoke", "arctic-480b-smoke")


@pytest.mark.parametrize("name,fuse", SERVE_RUNS, ids=SERVE_IDS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serving_matches_jax(arch, name, fuse):
    pair, tt = serve_pair(arch, name, fuse)
    if name == "paged" and fuse:
        # the shared limit, pinned: batched ticks drop other tokens than
        # the one-request reference does, in JAX too
        assert tt != serve_arch("torch", pair, "log", True, seq=True)[0]
