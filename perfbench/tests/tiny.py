"""Small cells for the CPU tests: the smoke siblings of the benchmark's
configurations and scaled-down mixes, run through the same loop code."""
from __future__ import annotations

import copy
import json
from pathlib import Path

from perfbench import bench

ROOT = Path(__file__).resolve().parents[2]


def smoke_config(name: str, kv_heads: int | None = None) -> dict:
    """The configuration file of ``name`` with the widths of the port's
    ``<name>-smoke`` sibling (GQA kept when ``kv_heads`` is given)."""
    from repro_torch.configs import get_config
    with open(ROOT / "perfbench" / "configs" / f"{name}.json") as f:
        c = json.load(f)
    s = get_config(name + "-smoke")
    c.update(name=s.name, num_hidden_layers=s.num_layers,
             hidden_size=s.d_model, num_attention_heads=s.num_heads,
             num_key_value_heads=kv_heads or s.num_kv_heads,
             head_dim=s.head_dim, intermediate_size=s.d_ff,
             vocab_size=s.vocab_size)
    return c


def traffic(name: str) -> dict:
    with open(ROOT / "perfbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def small_mix(name: str) -> dict:
    """``name``'s mix at a size the CPU runs in a few seconds, also while
    the rest of the suite loads every core (run with 3 s windows)."""
    t = copy.deepcopy(traffic(name))
    if t["loop"] == "train":
        t.update(seq_len=64)
        return t
    t.update(requests=64)
    t["prompt"].update(median=40, min=8, max=120)
    t["output"].update(median=6, min=2, max=24)
    t["serve"].update(max_len=256, max_batch_seqs=4, kv_hbm_bytes=1 << 20)
    if t["serve"]["prefill_chunk_tokens"]:
        t["serve"]["prefill_chunk_tokens"] = 16
    t["check"].update(served_tokens=24, max_tokens=2000)
    if t["loop"] == "closed":
        t.update(clients=4, warmup_ticks=4)
    else:
        t.update(rate_per_s=3.0, warmup_s=1.0)
    return t


def cell(workload: str, kv_heads: int = 2) -> bench.Cell:
    """``workload`` at smoke size, with its own limits and metrics. A train
    cell runs in fp32 here: at smoke widths a bf16 step's loss strays
    about 1e-4 from the reference's (5e-6 at the published widths on the
    card), past the limit set for the published widths."""
    full = bench.resolve(workload, ROOT)
    config = smoke_config(full.workload["config"], kv_heads)
    mix = small_mix(full.workload["traffic"])
    if mix["loop"] == "train":
        config["torch_dtype"] = "float32"
    return bench.Cell(workload, full.workload, config, mix,
                      dict(full.limits), full.end_to_end, full.per_layer,
                      ROOT)
