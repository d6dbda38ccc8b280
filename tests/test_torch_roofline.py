"""The port's roofline against the JAX package's: ``model_flops``,
``analytic_memory_bytes``, ``sample_plan`` and the parameter counts equal
for every arch and applicable shape; ``reconstruct_totals`` on one set of
artifacts equals the reference's; ``CollectiveOp.wire_bytes`` keeps the
reference's ring factors; ``roofline_cell``'s terms follow from the H100
record; and ``CostMode`` counts one rank's collectives, flops and bytes
on a fake world."""
import json

import pytest
import torch

from repro.configs import ARCH_IDS, SHAPES_BY_NAME as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.roofline import analysis as JA
from repro.roofline import hlo as JH
from repro_torch.configs import SHAPES_BY_NAME, applicable_shapes, get_config
from repro_torch.roofline import analysis as PA
from repro_torch.roofline.comms import CollectiveOp, CostMode
from repro_torch.roofline.hw import H100


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_flops_and_memory_floors_are_the_references(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert PA.sample_plan(cfg) == JA.sample_plan(jcfg)
    assert PA._full_counts(cfg) == JA._full_counts(jcfg)
    for s in PA.sample_plan(cfg):
        assert PA._counts(cfg, s["layers"], s.get("period")) == JA._counts(
            jcfg, s["layers"], s.get("period"))
    for shape in applicable_shapes(cfg):
        jshape = JAX_SHAPES[shape.name]
        assert PA.model_flops(cfg, shape) == JA.model_flops(jcfg, jshape)
        for devices in (256, 512):
            for mb in (1, 2, 8):
                assert PA.analytic_memory_bytes(cfg, shape, devices, mb) == \
                    JA.analytic_memory_bytes(jcfg, jshape, devices, mb)


def _artifacts(tmp_path, arch, shape, mesh="pod"):
    """A full-depth artifact and one per sample (made-up totals, affine in
    the block counts as real ones are)."""
    cfg = get_config(arch)
    for i, s in enumerate(PA.sample_plan(cfg)):
        tag = f"{arch}__{shape}__{mesh}__L{s['layers']}"
        if s.get("period"):
            tag += f"P{s['period']}"
        c = PA._counts(cfg, s["layers"], s.get("period"))
        art = {"cost": {"flops": 1e12 * c[0] + 3e11 * sum(c[1:]) + i,
                        "bytes accessed": 5e10 * sum(c)},
               "collectives": {"total_wire_bytes": 2e9 + 7e8 * c[1]}}
        (tmp_path / f"{tag}.json").write_text(json.dumps(art))
    full = {"microbatches": 2, "fits_hbm": True, "fits_v5e_hbm": True,
            "per_device_live_bytes": 12.5e9}
    (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(full))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-236b",
                                  "zamba2-1.2b"])
def test_reconstructed_totals_are_the_references(arch, tmp_path):
    _artifacts(tmp_path, arch, "train_4k")
    assert PA.reconstruct_totals(arch, "train_4k", tmp_path) == \
        JA.reconstruct_totals(arch, "train_4k", tmp_path)


def test_roofline_terms_follow_from_the_h100(tmp_path):
    arch, shape = "internlm2-1.8b", "train_4k"
    _artifacts(tmp_path, arch, shape)
    row = PA.roofline_cell(arch, shape, tmp_path)
    tot = PA.reconstruct_totals(arch, shape, tmp_path)
    cfg = get_config(arch)
    assert row.compute_s == tot["flops"] / 989e12
    assert row.memory_hlo_s == tot["bytes"] / 3.35e12
    assert row.memory_s == PA.analytic_memory_bytes(
        cfg, SHAPES_BY_NAME[shape], 256, 2) / 3.35e12
    assert row.collective_s == tot["wire"] / 450e9
    assert row.bound == max(("compute", row.compute_s),
                            ("memory", row.memory_s),
                            ("collective", row.collective_s),
                            key=lambda kv: kv[1])[0]
    assert row.fits_hbm and row.live_gb == 12.5
    assert (H100.peak_flops_bf16, H100.hbm_bandwidth, H100.nvlink_bandwidth,
            H100.sms, H100.smem_per_sm) == (989e12, 3.35e12, 450e9, 132,
                                            228 * 1024)
    assert "| internlm2-1.8b | train_4k |" in PA.render_table([row])


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("group", [1, 2, 16, 256])
def test_wire_bytes_keep_the_reference_ring_factors(kind, group):
    for result, operand in ((4096, 256), (1 << 20, 1 << 20), (6, 10)):
        got = CollectiveOp(kind, result, operand, group).wire_bytes
        assert got == JH.CollectiveOp(kind, result, operand,
                                      group).wire_bytes


@pytest.fixture
def fake_world():
    import torch.distributed as dist

    from repro_torch.launch.mesh import start_fake_world
    start_fake_world(4)
    yield
    dist.destroy_process_group()


def test_cost_mode_counts_one_ranks_work_on_a_fake_world(fake_world):
    """On a fake 2 × 2 world: a row-sharded product's partial sum is one
    all-reduce over ``model`` (group 2, the local output's bytes); the
    flops are the local product's, not the global one's or DTensor's
    shape propagation's; a gather over ``data`` is one all-gather."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((2, 2), device_type="cpu")
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(4, 8), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        w = DTensor.from_local(torch.empty(8, 16), mesh,
                               [Replicate(), Shard(0)], run_check=False)
        with CostMode() as cm:
            y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])
            y.redistribute(mesh, [Replicate(), Replicate()])
    assert cm.flops == 2 * 4 * 8 * 16
    kinds = [(op.kind, op.group_size, op.operand_bytes) for op in
             cm.collectives]
    assert kinds == [("all-reduce", 2, 4 * 16 * 4),
                     ("all-gather", 2, 4 * 16 * 4)]
    s = cm.summary()
    assert s["num_ops"] == 2 and s["total_wire_bytes"] == (
        2 * 0.5 * 256 + 0.5 * 512)
    assert cm.peak_bytes > 0 and cm.bytes_accessed > 0


@pytest.mark.parametrize("fake", [False, True])
def test_cost_mode_counts_a_backward_fill_in_place(fake):
    """A gather's backward fills a fresh zeros buffer: in place in an eager
    run, out of place under a dispatch mode. ``CostMode`` counts the eager
    peak: the (N, V) gradient once, on real and fake tensors alike, while
    the same out-of-place pair outside a backward holds both buffers."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode
    N, V = 64, 1000
    big = N * V * 4
    with FakeTensorMode() if fake else contextlib.nullcontext():
        x = torch.zeros(N, V, requires_grad=True)
        idx = torch.zeros(N, 1, dtype=torch.long)
        with CostMode() as cm:
            x.gather(1, idx).sum().backward()
        assert big <= cm.peak_bytes < 2 * big
        with CostMode() as cm:
            y = x.detach().new_zeros(N, V).scatter_add(1, idx,
                                                       torch.ones(N, 1))
        assert cm.peak_bytes >= 2 * big
    assert y.shape == (N, V)
