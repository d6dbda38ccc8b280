"""``chip_smoke.py``'s own contract, checkable without a card: every kernel
row names the TPU kernel it replaces by the line of its ``pl.pallas_call``
and the CUDA source that replaces it, and without a GPU the script exits
non-zero and prints no result."""
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("name", sorted(chip_smoke.KERNELS))
def test_kernel_rows_name_the_pallas_call_and_source(name):
    replaces, source = chip_smoke.KERNELS[name]
    path, line = replaces.rsplit(":", 1)
    text = (ROOT / path).read_text().splitlines()
    assert "pl.pallas_call(" in text[int(line) - 1], replaces
    assert (ROOT / source).is_file(), source


def test_refuses_without_a_gpu(tmp_path):
    """Here torch sees no GPU: exit 2, no result line — from the checkout
    and from a directory holding only the script."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script would run in full")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True, timeout=120,
                              cwd=script.parent)
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout


WORKLOADS = [wl.name for wl in chip_smoke.all_workloads(1 << 20, 1 << 20)]


@pytest.mark.parametrize("name", WORKLOADS)
def test_fio_copy_draws_the_reference_ops(name):
    """The script's copy of the fio mix (``benchmarks/common.py``, which
    the script may not import) draws the same offsets and read flags as
    the reference for each workload, at two seeds."""
    import numpy as np
    from benchmarks import common
    assert chip_smoke.MIXES == common.MIXES
    for seed in (0, 3):
        wl = next(w for w in chip_smoke.all_workloads(8 << 20, 2 << 20,
                                                      seed) if w.name == name)
        ref = next(w for w in common.all_workloads(8 << 20, 2 << 20, seed)
                   if w.name == name)
        assert (wl.read_frac, wl.zipf, wl.n_ops, wl.block) == (
            ref.read_frac, ref.zipf, ref.n_ops, ref.block)
        offsets, is_read = chip_smoke.fio_ops(wl)
        rng = np.random.default_rng(ref.seed)
        want = common.gen_offsets(ref, rng)
        np.testing.assert_array_equal(offsets, want)
        np.testing.assert_array_equal(is_read,
                                      rng.random(ref.n_ops) < ref.read_frac)


def test_peak_rss_sees_a_block_and_not_what_came_before():
    """``PeakRss`` reads the peak inside its block: 256 MiB held there
    shows, and a block after it is freed does not carry that peak on."""
    import gc
    with chip_smoke.PeakRss(every=0.005) as base:
        pass
    with chip_smoke.PeakRss(every=0.005) as held:
        buf = bytearray(256 << 20)
        buf[::4096] = b"\x01" * len(buf[::4096])
        time.sleep(0.05)
        del buf
        gc.collect()
    with chip_smoke.PeakRss(every=0.005) as after:
        pass
    assert held.gib >= base.gib + 0.2
    assert after.gib < held.gib - 0.2


def test_script_imports_neither_benchmarks_nor_the_jax_package():
    text = (ROOT / "chip_smoke.py").read_text()
    for bad in ("import benchmarks", "from benchmarks", "import jax",
                "from jax", "import repro\n", "from repro.", "import repro."):
        assert bad not in text, bad


def test_kernel_rows_cover_every_pallas_call_once():
    """One row for each ``pl.pallas_call`` of the JAX package, no more:
    the file-system tier adds no kernel."""
    sites = set()
    for path in sorted((ROOT / "src" / "repro" / "kernels").rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if "pl.pallas_call(" in line:
                sites.add(f"{path.relative_to(ROOT)}:{i}")
    rows = [replaces for replaces, _ in chip_smoke.KERNELS.values()]
    assert len(rows) == len(set(rows)) == len(sites) == 10
    assert set(rows) == sites


@pytest.mark.parametrize("name", sorted(chip_smoke.SCATTERS))
def test_scatter_rows_name_the_xla_scatter_and_source(name):
    """A kernel of the port with no pallas_call behind it names the JAX
    package's dropping scatter it replaces, and its CUDA source."""
    replaces, source = chip_smoke.SCATTERS[name]
    path, line = replaces.rsplit(":", 1)
    text = (ROOT / path).read_text().splitlines()[int(line) - 1]
    assert ".at[" in text and 'mode="drop"' in text, replaces
    assert (ROOT / source).is_file(), source
    assert name in {e.__name__ for e in __import__(
        "repro_torch.kernels", fromlist=["COUNTED"]).COUNTED}


def test_launch_counts_hold_one_write_a_paged_attention_launch():
    """``launch_counts`` reads every counted entry and refuses a run whose
    K/V writes are not one a single-layer paged attention launch;
    ``launched_besides`` leaves the write out."""
    from types import SimpleNamespace

    def entry(name, n):
        return SimpleNamespace(__name__=name, launches=n)
    ops = SimpleNamespace(COUNTED=(
        entry("paged_attention_ragged", 48), entry("paged_attention_q8", 24),
        entry("paged_attention_layers", 1), entry("kv_page_write", 72)))
    counts = chip_smoke.launch_counts(ops)
    assert counts["kv_page_write"] == 72
    assert chip_smoke.launched_besides(counts, "paged_attention_ragged") \
        == {"paged_attention_q8": 24, "paged_attention_layers": 1}
    ops.COUNTED[-1].launches = 71
    with pytest.raises(AssertionError, match="71 kv_page_write"):
        chip_smoke.launch_counts(ops)


@pytest.mark.parametrize("family", sorted(chip_smoke.WRITE_PLANES))
def test_kv_write_row_rehearses_on_the_cpu(monkeypatch, family):
    """Phase 2's K/V write row on the CPU at narrow planes (the entry runs
    its plain version there): the whole pool bit for bit, the two dead
    table entries dropped, ``index_put_`` agreeing, and the row's fields."""
    class Event:
        def __init__(self, **_):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(chip_smoke, "WRITE_GEOM", dict(
        B=6, Q=8, T=16, MP=200, chunk_rows=2))
    narrow = {"bfloat16": [((2, 8), "bfloat16")] * 2,
              "int8": [((2, 8), "int8")] * 2 + [((2,), "bfloat16")] * 2,
              "mla": [((16,), "bfloat16"), ((8,), "bfloat16")]}
    monkeypatch.setattr(chip_smoke, "WRITE_PLANES", narrow)
    c = chip_smoke.kv_write_case(torch, torch.device("cpu"), family, 3)
    c.iters = (2, 2, 2)
    fields = chip_smoke.measure(torch, "kv_page_write", c, family)
    assert fields["max_abs_err"] == 0.0
    assert fields["written_slots"] == 4 * 1 + 2 * 8 - 2
    assert fields["planes"] == len(narrow[family])
    assert fields["bound_by"] == "bytes" and fields["bound_ms"] > 0


def test_script_runs_the_training_phases_last():
    """``main`` runs train, parity-train and train-crash, in that order,
    after the checkpoint phases; train drives the CLI at InternLM2-1.8B's
    full width on 4 x 2048 tokens (past ``chunk_size``, so #9 runs) for 8
    steps."""
    import inspect
    src = inspect.getsource(chip_smoke.main)
    at = [src.index(s) for s in ('stamp(f"ckpt-{design}")', "train(torch",
                                 "parity_train(torch", "train_crash(torch",
                                 'stamp("train-crash")')]
    assert at == sorted(at)
    assert (chip_smoke.TRAIN_ARCH, chip_smoke.TRAIN_STEPS,
            chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ) == (
        "internlm2-1.8b", 8, 4, 2048)
    assert chip_smoke.TRAIN_SEQ > 512
    assert [a for a, _, _ in chip_smoke.PARITY_TRAIN] == [
        "internlm2-1.8b", "deepseek-v2-236b-noexperts"]
    assert (chip_smoke.CRASH_STEPS, chip_smoke.CRASH_AT) == (30, 25)


def test_training_phases_rehearse_on_the_cpu(monkeypatch, capsys):
    """Phases 32-33 at smoke size on the CPU, the flash entry's plain
    version counted as its launches: train launches it layers x (forward
    + remat recompute) x steps times and nothing else, its step-0 loss is
    the plain attention's; parity-train launches it twice a layer and
    holds the loss and every gradient leaf."""
    import repro_torch.kernels as ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch import train as train_cli
    from repro_torch.models import attention

    def counted(q, k, v, *, causal=True, scale=None, **_):
        counted.launches += 1
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    counted.__name__, counted.launches = "flash_attention", 0
    monkeypatch.setattr(flash_ops, "flash_attention", counted)
    monkeypatch.setattr(attention, "flash_attention", counted)
    for name in ("ENTRIES", "COUNTED"):
        monkeypatch.setattr(ops, name, tuple(
            counted if e.__name__ == "flash_attention" else e
            for e in getattr(ops, name)))
    monkeypatch.setattr(flash_ops, "reset_launch_counts",
                        lambda: setattr(counted, "launches", 0))

    class Event:
        def __init__(self, **_):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    main = train_cli.main

    def cpu_main(argv, report):
        out = main(argv, report=report)
        report["peak_bytes"] = 0            # no device memory on the CPU
        return out
    monkeypatch.setattr(train_cli, "main", cpu_main)
    monkeypatch.setattr(chip_smoke, "TRAIN_ARCH", "internlm2-1.8b-smoke")
    monkeypatch.setattr(chip_smoke, "TRAIN_STEPS", 3)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 520)
    monkeypatch.setattr(chip_smoke, "TRAIN_FLASH", dict(
        B=2, Sq=520, Skv=520, H=4, K=4, D=32, DV=32, causal=True))
    monkeypatch.setattr(chip_smoke, "PARITY_TRAIN", (
        ("internlm2-1.8b-smoke", 2, 520),
        ("deepseek-v2-236b-noexperts-smoke", 2, 520)))
    cpu = torch.device("cpu")
    counts, report = chip_smoke.train(torch, cpu, 0)
    assert counts["flash_attention"] == 2 * 2 * 3
    assert sum(counts.values()) == counts["flash_attention"]
    assert report["tokens_per_s"] > 0
    counts = chip_smoke.parity_train(torch, cpu, 0)
    assert counts["flash_attention"] == 2 * 2 + 2 * 2
    out = capsys.readouterr().out
    assert "rel 0.000e+00 (tolerance 1e-2, bf16)" in out
    assert out.count("worst gradient leaf") == 2


def test_script_runs_the_distribution_phases_last():
    """``main`` runs dryrun, dryrun-card, ep-card and examples after
    train-crash, in that order: the dry run's cells at full width on the
    fake pod (and one multipod) mesh, the (1, 1) mesh's InternLM2-1.8B cut
    to 2 layers at batches 4 and 1, and the two EP paths at token counts
    on either side of ``apply_moe``'s 4096-token switch."""
    import inspect
    src = inspect.getsource(chip_smoke.main)
    at = [src.index(s) for s in (
        'stamp("train-crash")', "dryrun_phase(torch", 'stamp("dryrun")',
        "dryrun_card(", 'stamp("dryrun-card")', "ep_card(torch",
        'stamp("ep-card")', "examples_phase(torch", 'stamp("examples")',
        "print(smi_line())")]
    assert at == sorted(at)
    assert chip_smoke.DRYRUN_CELLS == (
        ("internlm2-1.8b", "train_4k", False, 2),
        ("internlm2-1.8b", "prefill_32k", False, None),
        ("internlm2-1.8b", "decode_32k", False, None),
        ("deepseek-v2-236b", "train_4k", False, 2),
        ("mamba2-1.3b", "decode_32k", False, None),
        ("zamba2-1.2b", "decode_32k", False, None),
        ("internlm2-1.8b", "train_4k", True, 2))
    assert (chip_smoke.CARD_ARCH, chip_smoke.CARD_LAYERS,
            chip_smoke.CARD_BATCH) == ("internlm2-1.8b", 2,
                                       {"train_4k": 4, "prefill_32k": 1})
    lo, hi = chip_smoke.CARD_PEAK_BAND
    assert lo <= 1.0 <= hi and "CARD_PEAK_BAND" in inspect.getsource(
        chip_smoke.dryrun_card)
    (ep, n_ep, _), (tg, n_tg, cf_tg) = chip_smoke.EP_CASES
    assert (ep, tg, cf_tg) == ("_moe_ep", "_moe_ep_tokengather", None)
    assert n_ep > 4096 >= n_tg
    assert chip_smoke.EP_ARCH == "deepseek-v2-236b"


def test_card_peaks_come_from_the_h100_record():
    from repro_torch.roofline.hw import H100
    assert chip_smoke.HBM_BYTES_PER_S == H100.hbm_bandwidth == 3.35e12
    assert chip_smoke.FLOPS_PER_S == {"bfloat16": 989e12, "float32": 67e12,
                                      "tf32x3": 495e12 / 3}
