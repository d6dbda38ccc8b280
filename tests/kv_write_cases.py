"""Cases of the paged K/V write (``kv_page_write``), shared by its CPU tests
(``tests/test_torch_kv_write.py``), its tests on the card
(``tests/test_torch_cuda.py``) and ``chip_smoke.py``'s row for it. Imports
torch and numpy only.

A case is one step's write into one layer's pool planes: ``(pools, values,
block_table, positions, valid)``, built on the CPU from a numpy seed, with
positions ``ctx + arange(Q)`` and ``valid = arange(Q) < q_len`` as the
serving steps make them. :func:`chat_step` gives a chat tick's rows at
full size, on any device.
"""
from __future__ import annotations

import numpy as np
import torch

# each pool family's planes: (trailing shape, pool dtype, value dtype); the
# bf16 dense family's values arrive in fp32 and are cast by the write
FAMILIES = {
    "dense-f32": [((2, 8), torch.float32, torch.float32)] * 2,
    "dense-bf16": [((2, 8), torch.bfloat16, torch.float32)] * 2,
    "int8": [((2, 8), torch.int8, torch.int8)] * 2
    + [((2,), torch.bfloat16, torch.bfloat16)] * 2,
    "mla": [((16,), torch.bfloat16, torch.bfloat16),
            ((8,), torch.bfloat16, torch.bfloat16)],
}

P, T, MP = 16, 4, 4          # pages, slots a page, table columns


def _rows(edge):
    """(ctx, q_lens, Q) of each edge: ``mixed`` a q_len-0 padding row, a
    decode row, a chunk across two page boundaries and one inside a page;
    ``padding`` every row q_len 0; ``bad_table`` the mixed rows with table
    entries of -1 and past the pool; ``past_table`` chunks running past the
    table's last column (clamped to it; no two slots share a target)."""
    if edge == "padding":
        return [0, 3, 9], [0, 0, 0], 6
    if edge == "past_table":
        return [MP * T - 2, MP * T - 1, 5], [4, 2, 1], 4
    return [0, 5, 3, 9], [0, 1, 6, 3], 6


def case(family, edge, seed=0):
    rng = np.random.default_rng(seed)
    ctx, q_lens, Q = _rows(edge)
    B = len(ctx)
    positions = torch.tensor(ctx)[:, None] + torch.arange(Q)[None, :]
    valid = torch.arange(Q)[None, :] < torch.tensor(q_lens)[:, None]
    table = rng.permutation(P)[:B * MP].reshape(B, MP).astype(np.int32)
    for b, q in enumerate(q_lens):
        if q == 0:
            table[b] = 0          # the engine's padding rows: page 0
    if edge == "bad_table":
        table[1, 1] = -1          # the decode row's page (position 5)
        table[2, 1] = P           # the chunk's second page
        table[3, 2] = P + 5       # the short chunk's page (positions 9-11)
    pools, values = [], []
    for shape, pool_dt, val_dt in FAMILIES[family]:
        pools.append(_draw(rng, (P, T) + shape, pool_dt))
        values.append(_draw(rng, (B, Q) + shape, val_dt))
    return pools, values, torch.from_numpy(table), positions, valid


def _draw(rng, shape, dtype):
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(-127, 128, shape,
                                             dtype=np.int8))
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def loop_write(pools, values, table, positions, valid):
    """The write slot by slot in Python: the semantics the entry states."""
    B, Q = positions.shape
    n_pages, n_slots = pools[0].shape[:2]
    for b in range(B):
        for i in range(Q):
            if not bool(valid[b, i]):
                continue
            pos = int(positions[b, i])
            page = int(table[b, min(max(pos // n_slots, 0),
                                    table.shape[1] - 1)])
            if not 0 <= page < n_pages:
                continue
            for pool, val in zip(pools, values):
                pool[page, pos % n_slots] = val[b, i].to(pool.dtype)


def written_slots(pools_before, pools_after):
    """How many (page, slot) rows of the first plane changed."""
    a, b = pools_before[0], pools_after[0]
    return int((a.view(torch.uint8) != b.view(torch.uint8))
               .flatten(2).any(-1).sum())


def same_bytes(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


EDGES = ("mixed", "padding", "bad_table", "past_table")
CASES = [(f, e) for f in FAMILIES for e in EDGES]
# (page, slot) rows each edge writes: so a case cannot pass by writing
# nothing, nor by dropping nothing
WRITTEN = {"mixed": 10, "padding": 0, "bad_table": 2, "past_table": 7}


def chat_step(dev, B=64, Qm=128, T=16, MP=256, chunk_rows=3, seed=0):
    """A chat tick's rows: ``B - chunk_rows`` decode rows and
    ``chunk_rows`` chunks of ``Qm``, at lengths up to 3072, each row on
    pages of its own in a pool of ``B * MP`` pages. Returns (table,
    positions, valid)."""
    g = torch.Generator(dev).manual_seed(seed)
    table = torch.randperm(B * MP, generator=g, device=dev).view(B, MP).int()
    ctx = torch.randint(64, 3072, (B,), generator=g, device=dev)
    q_lens = torch.ones(B, dtype=torch.long, device=dev)
    q_lens[:chunk_rows] = Qm
    ar = torch.arange(Qm, device=dev)
    return table, ctx[:, None] + ar, ar < q_lens[:, None]
