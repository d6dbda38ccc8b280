"""The paged steps' two sync-free pieces on the CPU: the pool write's plain
version (``kv_page_write_ref``, the boolean-index body ``_scatter_pool``
had, and what ``kv_page_write`` and ``_scatter_pool`` run on CPU tensors)
against a slot-by-slot loop, byte for byte; and RoPE's inverse-frequency
table, kept on each device. The write kernel itself is held against the
same cases on the card in ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

from kv_write_cases import (CASES, WRITTEN, case, loop_write, same_bytes,
                            written_slots)
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import kv_page_write_ref
from repro_torch.models import attention, layers


def _clone(pools):
    return [p.clone() for p in pools]


@pytest.mark.parametrize("family,edge", CASES)
def test_write_reference_is_the_slot_by_slot_write(family, edge):
    """Dense, int8 and MLA planes; padding rows and q_len 0, table entries
    of -1 and past the pool (dropped), positions past the table (clamped):
    the plain version, the entry and ``_scatter_pool`` leave every plane
    byte for byte as the loop does."""
    pools, values, table, positions, valid = case(family, edge)
    want = _clone(pools)
    loop_write(want, values, table, positions, valid)
    assert written_slots(pools, want) == WRITTEN[edge]
    for write in (kv_page_write_ref, ops.kv_page_write,
                  attention._scatter_pool):
        got = _clone(pools)
        write(got, values, table, positions, valid)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            assert same_bytes(g, w), write.__name__


def test_write_on_the_cpu_counts_no_launch():
    pools, values, table, positions, valid = case("dense-bf16", "mixed")
    ops.reset_launch_counts()
    ops.kv_page_write(pools, values, table, positions, valid)
    assert ops.kv_page_write.launches == 0
    assert ops.kv_page_write not in ops.ENTRIES
    assert ops.kv_page_write in ops.COUNTED


def test_reset_sets_the_writes_count_to_zero():
    """Both resets cover the write, as every other counted entry."""
    import repro_torch.kernels as kernels
    assert ops.kv_page_write in kernels.COUNTED
    for reset in (ops.reset_launch_counts, kernels.reset_launch_counts):
        ops.kv_page_write.launches = 5
        reset()
        assert ops.kv_page_write.launches == 0


def _numpy_table(head_dim, theta):
    e = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    return 1.0 / (theta ** e)


@pytest.fixture
def fresh_tables(monkeypatch):
    """An empty table cache, and a count of the tables built."""
    built = []
    build = layers.rope_frequencies

    def counted(head_dim, theta, device=None):
        built.append((head_dim, theta, torch.device(device)))
        return build(head_dim, theta, device)
    monkeypatch.setattr(layers, "_ROPE_TABLES", {})
    monkeypatch.setattr(layers, "rope_frequencies", counted)
    return built


@pytest.mark.parametrize("head_dim,theta", [(128, 1e6), (64, 10000.0),
                                            (32, 500000.0), (16, 1e4)])
def test_rope_table_is_numpy_float32_bit_for_bit(fresh_tables, head_dim,
                                                 theta):
    x = torch.zeros(1, 3, 2, head_dim)
    table = layers._rope_table(head_dim, theta, x)
    want = _numpy_table(head_dim, theta)
    assert table.dtype == torch.float32 and want.dtype == np.float32
    assert np.array_equal(table.numpy().view(np.int32), want.view(np.int32))
    assert layers._rope_table(head_dim, theta, x) is table


def test_rope_table_is_built_once_per_head_dim_theta_and_device(
        fresh_tables):
    pos = torch.arange(5)[None]
    for _ in range(3):
        layers.apply_rope(torch.randn(1, 5, 2, 64), pos, 1e6)
    assert len(fresh_tables) == 1
    layers.apply_rope(torch.randn(1, 5, 2, 64), pos, 1e4)      # theta
    layers.apply_rope(torch.randn(1, 5, 2, 32), pos, 1e6)      # head_dim
    layers.apply_rope(torch.randn(1, 5, 2, 64, device="meta"),
                      pos.to("meta"), 1e6)                      # device
    for hd, theta in ((64, 1e6), (64, 1e4), (32, 1e6)):
        layers.apply_rope(torch.randn(1, 5, 2, hd), pos, theta)
    assert len(fresh_tables) == 4
    assert set(layers._ROPE_TABLES) == {
        (64, 1e6, torch.device("cpu")), (64, 1e4, torch.device("cpu")),
        (32, 1e6, torch.device("cpu")), (64, 1e6, torch.device("meta"))}


def test_rope_with_the_kept_table_is_rope_with_a_new_one(fresh_tables):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 7, 4, 64)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 4000, (2, 7)))
    first = layers.apply_rope(x, pos, 1e6)
    again = layers.apply_rope(x, pos, 1e6)
    freqs = torch.from_numpy(_numpy_table(64, 1e6))
    angles = pos[..., None].float() * freqs
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    want = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    assert len(fresh_tables) == 1
    assert torch.equal(first, want) and torch.equal(again, want)


def test_rope_table_stays_off_the_cache_for_fake_tensors(fresh_tables):
    with FakeTensorMode() as mode:
        x = mode.from_tensor(torch.randn(1, 5, 2, 64))
        pos = mode.from_tensor(torch.arange(5)[None])
        for _ in range(2):
            out = layers.apply_rope(x, pos, 1e6)
            assert is_fake(out) and out.shape == x.shape
    assert len(fresh_tables) == 2
    assert layers._ROPE_TABLES == {}
    # a real call after it builds and keeps a real table
    layers.apply_rope(torch.randn(1, 5, 2, 64), torch.arange(5)[None], 1e6)
    (table,) = layers._ROPE_TABLES.values()
    assert not is_fake(table) and len(fresh_tables) == 3
