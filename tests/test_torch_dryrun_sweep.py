"""The dry run's sweep cells that the residual stream's placement decides,
at published widths and 2 layers on the production fake worlds (256 and
512 ranks, ``--device cpu``), one subprocess a cell, all at once: a cell
for each way an unsettled row-parallel ``Partial`` used to end —

* Gemma-7B × train_4k × pod: carried into the logits (tied table), so
  the NLL's ``local_map`` was handed a ``Partial`` input;
* Zamba2-1.2B × train_4k × multipod: the same, on a batch folded over
  ``data`` × ``model``;
* InternLM2-1.8B × prefill_32k × pod: reduce-scattered onto the
  flattened rows, a strided shard whose ``mm`` DTensor cannot propagate
  on fake tensors —

and InternLM2-1.8B × train_4k × pod, whose counts are pinned to the
card's host (torch 2.11) run of the same cell. Each cell's arguments
equal the JAX cell's local bytes, and no ``Partial`` reached a
``local_map`` input (``partial_guard_fires``). A smoke-width run on a
2 × 2 fake mesh shows the layouts themselves; the CLI and
``scripts/dryrun_sweep.py`` step the same cells and fail one whose guard
fired."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_dryrun import jax_argument_bytes

REPO = Path(__file__).resolve().parent.parent
LAYERS = 2
# (arch, shape, multi-pod, mesh dims)
CELLS = [("gemma-7b", "train_4k", False, (16, 16)),
         ("zamba2-1.2b", "train_4k", True, (2, 16, 16)),
         ("internlm2-1.8b", "prefill_32k", False, (16, 16))]
PIN = ("internlm2-1.8b", "train_4k", False, (16, 16))
# InternLM2-1.8B × train_4k × pod at 2 layers on the card's host (torch
# 2.11.0+cu128, NVIDIA H100 80GB HBM3, scripts/dryrun_sweep.py --layers
# 2): collectives, wire bytes and live bytes of its artifact
CARD = {"num_ops": 72, "total_wire_bytes": 8750342407.96875,
        "per_device_live_bytes": 7097658900}


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("REPRO_TEST_MESH", None)
    return env


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Every cell's artifact (or the failed run's output), the cells run
    at once."""
    runs = {}
    for arch, shape, multi, _ in CELLS + [PIN]:
        out = tmp_path_factory.mktemp(f"{arch}_{shape}")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh",
               "multi" if multi else "single", "--layers", str(LAYERS),
               "--device", "cpu", "--out", str(out)]
        runs[arch, shape] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=_env(), cwd=REPO))
    res = {}
    for key, (out, proc) in runs.items():
        text = proc.communicate(timeout=600)[0]
        arts = list(out.glob("*.json"))
        res[key] = (json.loads(arts[0].read_text())
                    if proc.returncode == 0 and len(arts) == 1 else text)
    return res


def _artifact(cells, arch, shape):
    art = cells[arch, shape]
    assert isinstance(art, dict), art[-3000:]
    return art


@pytest.mark.parametrize("arch,shape,multi,dims", CELLS + [PIN])
def test_cell_steps_with_the_references_arguments_and_no_partial_input(
        cells, arch, shape, multi, dims):
    art = _artifact(cells, arch, shape)
    assert art["mesh"] == ("multipod" if multi else "pod")
    assert art["devices"] == (512 if multi else 256)
    assert art["partial_guard_fires"] == 0
    assert art["memory"]["argument_bytes"] == jax_argument_bytes(
        arch, shape, dims, art.get("microbatches", 1), layers=LAYERS)
    assert art["collectives"]["num_ops"] > 0 and art["cost"]["flops"] > 0


def test_internlm2_train_counts_what_the_cards_host_counts(cells):
    """The residual stream's placement set at every row-parallel product
    leaves DTensor no choice that differs between torch 2.11 (the card's
    host) and the release these tests run on: the same collectives and
    wire bytes, live bytes within 2%."""
    art = _artifact(cells, *PIN[:2])
    c = art["collectives"]
    assert c["num_ops"] == CARD["num_ops"]
    assert c["total_wire_bytes"] == pytest.approx(CARD["total_wire_bytes"],
                                                  rel=1e-9)
    assert art["per_device_live_bytes"] == pytest.approx(
        CARD["per_device_live_bytes"], rel=0.02)


LAYOUT = r'''
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import (make_test_mesh, prepare_groups,
                                     start_fake_world)
from repro_torch.launch.specs import abstract_params, install_params
from repro_torch.models import LM
from repro_torch.models import attention as A, blocks as B
from repro_torch.models.layers import apply_ffn

start_fake_world(4)
mesh = make_test_mesh((2, 2), ("data", "model"), "cpu")
prepare_groups(mesh)
out = {}
name = lambda t: [str(p) for p in t.placements]
with FakeTensorMode():
    cfg = get_config("internlm2-1.8b-smoke")
    # 16 tokens past chunk_size 8: the attention is #9's custom op, as
    # in the sweep's train and prefill cells
    model = LM(cfg, dtype=torch.bfloat16, device="cpu", chunk_size=8)
    install_params(model, S.distribute(abstract_params(model),
                                       S.param_specs(model, mesh), mesh),
                   False)
    tokens = S.distribute(torch.empty((4, 16), dtype=torch.int32),
                          S.batch_specs({"t": (4, 16)}, mesh)["t"], mesh)
    pos = torch.arange(16).expand(4, 16)
    blk = model.blocks[0]
    with implicit_replication(), torch.no_grad():
        h = model._embed_tokens(tokens)
        x = B._branch_in(blk.ln_attn, cfg, h)
        out["wo_product"] = name(A.attn_train(blk, cfg, x, pos,
                                              chunk_size=8)[0])
        h = B._attn_half(blk, cfg, h, pos, 8)[0]
        out["attn_half"] = name(h)
        out["w_down_product"] = name(apply_ffn(
            blk, B._branch_in(blk.ln_ffn, cfg, h), cfg.ffn_activation))
        h = B._ffn(blk, cfg, h)
        out["block"] = name(h)
        out["logits"] = name(model._logits(h, tokens))
    # the gradient a column-parallel product hands back is settled too
    w = S.distribute(torch.empty((cfg.d_model, 64)), S.P(None, "model"),
                     mesh).requires_grad_()
    hg = S.distribute(torch.empty((4, 16, cfg.d_model)), S.P("data"),
                      mesh).requires_grad_()
    with implicit_replication():
        (S.settle_residual(hg, tokens) @ w).sum().backward()
    out["branch_input_grad"] = name(hg.grad)
    # the guard: a Partial handed to a local_map input is resolved, counted
    S.partial_guard.clear()
    p = DTensor.from_local(torch.empty((2, 8)), mesh, (Shard(0), Partial()))
    out["resolved"] = name(S.resolve_partial(p, -1, "even"))
    odd = DTensor.from_local(torch.empty((2, 7)), mesh, (Shard(0), Partial()))
    out["resolved_odd"] = name(S.resolve_partial(odd, -1, "odd"))
    out["dim_shards"] = [str(q) for q in S.dim_shards(p, -1)[0]]
    out["guard"] = dict(S.partial_guard)
print(json.dumps(out))
'''


def test_row_parallel_outputs_and_logits_are_settled_at_smoke_width():
    """On a 2 × 2 fake mesh at smoke width: the raw ``wo`` and ``w_down``
    products are ``Partial`` on ``model``; the block's halves, once
    settled, are batch-sharded and replicated on ``model``; the logits
    come out vocab-sharded on ``model``; a branch input's gradient is
    settled as well. The guard reduce-scatters a ``Partial`` onto the
    dim it is given where that dim divides (else all-reduces), never
    hands one to ``dim_shards``' placements, and counts each."""
    r = subprocess.run([sys.executable, "-c", LAYOUT], capture_output=True,
                       text=True, env=_env(), cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    stream = ["S(0)", "R"]
    assert got["wo_product"] == ["S(0)", "P(sum)"]
    assert got["w_down_product"] == ["S(0)", "P(sum)"]
    assert got["attn_half"] == stream and got["block"] == stream
    assert got["logits"] == ["S(0)", "S(2)"]
    assert got["branch_input_grad"] == stream
    assert got["resolved"] == ["S(0)", "S(1)"]
    assert got["resolved_odd"] == ["S(0)", "R"]
    assert got["dim_shards"] == ["S(0)", "R"]
    assert got["guard"] == {"even": 1, "odd": 1, "dim_shards": 1}


def test_chip_smoke_steps_a_settled_cell_in_its_dry_run_phase():
    """``chip_smoke.py``'s dry-run phase steps Gemma-7B × train_4k × pod
    (2 layers) after its earlier cells, and fails a cell whose run handed
    a ``Partial`` to a ``local_map``."""
    import inspect
    sys.path.insert(0, str(REPO))
    import chip_smoke
    assert chip_smoke.DRYRUN_SETTLED == (("gemma-7b", "train_4k", False,
                                          LAYERS),)
    src = inspect.getsource(chip_smoke.dryrun_phase)
    assert "DRYRUN_CELLS + DRYRUN_SETTLED" in src
    # the pod cells first: one fake world a mesh size
    assert "key=lambda c: c[2]" in src
    assert 'r["partial_guard_fires"] == 0' in src


def test_the_cli_and_the_sweep_script_step_the_same_cells():
    """``--all --mesh both`` steps 64 cells, every pod cell before the
    multipod ones, and skips the eight quadratic archs' long_500k; the
    sweep script takes its list from the CLI."""
    from repro_torch.launch.dryrun import sweep_cells
    run, skip = sweep_cells()
    assert len(run) == 64 and len(set(run)) == 64
    assert [mp for _, _, mp in run] == [False] * 32 + [True] * 32
    assert len(skip) == 8 and {s for _, s, _ in skip} == {"long_500k"}
    sys.path.insert(0, str(REPO / "scripts"))
    import dryrun_sweep
    assert dryrun_sweep.cells() == (run, skip)


def _record(fires):
    return {"per_device_live_bytes": 1e9, "fits_hbm": True,
            "collectives": {"num_ops": 3}, "partial_guard_fires": fires,
            "run_s": 0.1}


@pytest.mark.parametrize("fires", [0, 2])
def test_the_cli_fails_a_cell_whose_guard_fired(fires, monkeypatch, capsys,
                                                tmp_path):
    """A cell that steps but handed a ``Partial`` to a ``local_map`` is a
    ``[FAIL]``, and the sweep exits 1."""
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "run_cell",
                        lambda *a, **k: _record(fires))
    argv = ["--arch", "gemma-7b", "--shape", "train_4k", "--mesh", "both",
            "--device", "cpu", "--out", str(tmp_path)]
    if fires:
        with pytest.raises(SystemExit) as e:
            dryrun.main(argv)
        assert e.value.code == 1
    else:
        dryrun.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    assert all(ln.startswith("[FAIL]" if fires else "[ok]") and
               f"partial_guard={fires}" in ln for ln in lines)


@pytest.mark.parametrize("fires", [0, 2])
def test_the_sweep_script_fails_a_cell_whose_guard_fired(fires, monkeypatch,
                                                         tmp_path):
    sys.path.insert(0, str(REPO / "scripts"))
    import dryrun_sweep

    class Done:
        returncode, stdout, stderr = 0, "", ""

    def run(cmd, **kw):
        name = dryrun_sweep.tag("gemma-7b", "train_4k", False, LAYERS)
        art = {"per_device_live_bytes": 1e9, "fits_hbm": True,
               "memory": {"argument_bytes": 1e8}, "run_s": 0.1,
               "collectives": {"num_ops": 3, "total_wire_bytes": 1e9},
               "cost": {"flops": 1e12}, "partial_guard_fires": fires}
        (tmp_path / f"{name}.json").write_text(json.dumps(art))
        return Done()
    monkeypatch.setattr(dryrun_sweep.subprocess, "run", run)
    args = dryrun_sweep.argparse.Namespace(
        layers=LAYERS, device="cpu", src=str(REPO / "src"), timeout=60)
    rec = dryrun_sweep.run_one(("gemma-7b", "train_4k", False), args,
                               tmp_path)
    assert rec["status"] == ("FAIL" if fires else "ok")
    assert rec["partial_guard_fires"] == fires
