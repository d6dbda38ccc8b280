"""Expert-parallel MoE: the port's ``_moe_ep`` and ``_moe_ep_tokengather``
on a 4-rank ``gloo`` group (a 2×2 data × model mesh) against the JAX
package's, run through ``shard_map`` on 4 host devices in a subprocess,
on the same seeded inputs at ``deepseek-v2-236b-smoke`` widths; and the
fixed-size expert counts against ``bincount``.

Tolerance: fp32, 1e-5 absolute and relative. The two packages add each
token's expert outputs and the ranks' partial sums in different orders.
"""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

REPO = Path(__file__).resolve().parent.parent
ARCH = "deepseek-v2-236b-smoke"
TOL = dict(rtol=1e-5, atol=1e-5)
# (path, tokens): _moe_ep past 4096 tokens is chosen by apply_moe; here
# each body is called directly at a smoke token count
CASES = (("ep", 64), ("tokengather", 16))

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.configs import get_config
    from repro.distributed.sharding import make_mesh, use_mesh
    from repro.models.moe import _moe_ep, _moe_ep_tokengather
    cfg = get_config(sys.argv[1])
    d = dict(np.load(sys.argv[2]))
    params = {"router": d["router"], "experts": {
        n: d[n] for n in ("w_gate", "w_up", "w_down")}}
    mesh = make_mesh((2, 2), ("data", "model"))
    fn = {"ep": _moe_ep, "tokengather": _moe_ep_tokengather}[sys.argv[4]]
    with use_mesh(mesh):
        y, aux = jax.jit(lambda p, x: fn(p, cfg, x, ("data",)))(params, d["x"])
    np.savez(sys.argv[3], y=np.asarray(y), aux=np.asarray(aux))
""")


def _inputs(T, seed=0):
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    m, d = cfg.moe, cfg.d_model
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(
        np.float32)
    return {"x": rng.standard_normal((T, d)).astype(np.float32),
            "router": f(d, m.num_experts),
            "w_gate": f(m.num_experts, d, m.d_expert),
            "w_up": f(m.num_experts, d, m.d_expert),
            "w_down": f(m.num_experts, m.d_expert, d)}


def _rank(rank, port, path, which, out):
    import torch.distributed as dist
    sys.path.insert(0, str(REPO / "src"))
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import P, to_placements
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        from torch.distributed.tensor import distribute_tensor
        mesh = make_test_mesh((2, 2), device_type="cpu")
        d = {k: torch.from_numpy(v) for k, v in np.load(path).items()}

        def put(t, spec):
            return distribute_tensor(t, mesh, to_placements(spec, mesh),
                                     src_data_rank=None)
        p = SimpleNamespace(
            router=put(d["router"], P(None, None)),
            experts=SimpleNamespace(
                w_gate=put(d["w_gate"], P("model", None, "data")),
                w_up=put(d["w_up"], P("model", None, "data")),
                w_down=put(d["w_down"], P("model", "data", None))))
        x = put(d["x"], P("data", None))
        fn = {"ep": moe._moe_ep,
              "tokengather": moe._moe_ep_tokengather}[which]
        y, aux = fn(p, get_config(ARCH), x, ("data",), mesh)
        y, aux = y.full_tensor(), aux.full_tensor()
        if rank == 0:
            np.savez(out, y=y.numpy(), aux=aux.numpy())
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("which,T", CASES)
def test_ep_paths_match_the_jax_shard_map_runs(which, T, tmp_path):
    np.savez(tmp_path / "in.npz", **_inputs(T))
    script = tmp_path / "jax_ep.py"
    script.write_text(JAX_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(script), ARCH,
                        str(tmp_path / "in.npz"), str(tmp_path / "jax.npz"),
                        which], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    mp.start_processes(_rank, args=(_free_port(), str(tmp_path / "in.npz"),
                                    which, str(tmp_path / "torch.npz")),
                       nprocs=4, start_method="spawn", join=True)
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "torch.npz")
    np.testing.assert_allclose(got["y"], want["y"], **TOL)
    np.testing.assert_allclose(got["aux"], want["aux"], **TOL)
    assert np.abs(want["y"]).max() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fixed_size_counts_are_bincounts(seed):
    from repro_torch.models.moe import _counts, _route
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 8, (97,), generator=g)
    for dtype in (torch.long, torch.float32):
        got = _counts(ids, 8, dtype)
        want = torch.bincount(ids, minlength=8).to(dtype)
        assert got.dtype == dtype and torch.equal(got, want)
    # the router's load-balancing loss: the same bits as with bincount
    x, w = torch.randn(33, 16, generator=g), torch.randn(16, 8, generator=g)
    top_ids, _, aux = _route(w, x, 8, 2)
    probs = torch.softmax(x.float() @ w.float(), dim=-1)
    ce = torch.bincount(top_ids.reshape(-1), minlength=8).float() / (33 * 2)
    assert torch.equal(aux, 8 * torch.sum(probs.mean(dim=0) * ce))
