"""Adding a cell is data only: a configuration, a traffic mix, a limits
file and a metric reader placed in another checkout's folders are found
by name, and the cell runs through the loop code as it stands."""
import json
import shutil
import time

import torch

from perfbench import bench
from perfbench.tests.tiny import ROOT, small_mix, smoke_config


def test_a_new_cell_is_found_by_name_and_runs(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for sub in ("configs", "traffic", "limits", "metrics"):
        (tmp_path / "perfbench" / sub).mkdir(parents=True)
    cfg = smoke_config("internlm2-1.8b", kv_heads=2)
    cfg["name"] = "extra-model"
    (tmp_path / "perfbench/configs/extra-model.json").write_text(
        json.dumps(cfg))
    mix = small_mix("conversation-closed64")
    mix["clients"] = 3
    (tmp_path / "perfbench/traffic/extra-mix.json").write_text(
        json.dumps(mix))
    (tmp_path / "perfbench/limits/extra-cell.json").write_text(
        json.dumps({"logit_gap": 0.05}))
    (tmp_path / "perfbench/metrics/extra_rows.serve.py").write_text(
        "def read(ctx):\n    return ctx['decode_rows'] + 0.5\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "extra-model", "source": "https://x.org",
                         "file": "perfbench/configs/extra-model.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "extra-cell", "config": "extra-model",
                           "traffic": "extra-mix", "chips": 1,
                           "why": "a test"})
    b["per_layer"].append({"name": "extra_rows.serve", "unit": "rows",
                           "better": "higher", "source": "program_counter",
                           "layer": "scheduler", "moves": "serve_tok_s",
                           "workloads": ["extra-cell"]})
    for m in b["end_to_end"]:
        if m["name"] in ("serve_tok_s", "ttft_p95_ms", "itl_p95_ms"):
            m["workloads"].append("extra-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = bench.resolve("extra-cell", tmp_path)
    assert cell.config["name"] == "extra-model"
    assert cell.traffic["clients"] == 3
    assert [m["name"] for m in cell.per_layer] == ["extra_rows.serve"]
    assert bench.metric_reader("extra_rows.serve", tmp_path)(
        {"decode_rows": 2}) == 2.5
    res, _ = bench.run_cell(cell, 11, 3.0, True, torch.device("cpu"),
                            time.perf_counter())
    assert res["correct"]
    assert res["metrics"]["extra_rows.serve"]["unit"] == "rows"
