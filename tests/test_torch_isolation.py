"""The port stands alone: serving through it — dense, int8 and MLA cache
families, the MoE configs (DeepSeek-V2 with its experts, Arctic), an
ungated FFN (StarCoder2) and the state-space families (Mamba-2 on its
state rows, the Zamba2 hybrid), with speculative decode, a prefix cache, a
token journal and a fault plan (a crash, then recovery), dense and MLA
prompts longer than ``chunk_size`` (the flash-attention prefill), and the
dense mirror through the ``log`` and ``kvhybrid`` engines and host-mode
``paged`` — the encoder-decoder and VLM configs at model level (prefill
with frontend embeddings, decode steps), and every public kernel entry
load neither JAX nor any module of the JAX package; nor do the file-system
tier (``NVCacheFS`` on every FS engine), the checkpoint manager, the
engine registry CLI, the training CLI (``python -m
repro_torch.launch.train``) and ``examples/train_lm_torch.py``, the dry
run (``python -m repro_torch.launch.dryrun``: the sharding rules, the
meshes, the specs, the roofline) and the examples' twins
(``examples/*_torch.py``). Without ``--device cpu`` the training CLI, its
example, the dry-run CLI and the serving twin raise here (no GPU)."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    for arch, kd in (("internlm2-1.8b-smoke", "native"),
                     ("internlm2-1.8b-smoke", "int8"),
                     ("deepseek-v2-236b-noexperts-smoke", "native"),
                     ("deepseek-v2-236b-smoke", "native"),
                     ("arctic-480b-smoke", "native"),
                     ("starcoder2-15b-smoke", "native")):
        cfg = get_config(arch)
        model = LM(cfg, device="cpu", kv_cache_dtype=kd).init(
            torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(0, 512, 6,
                                                   dtype=np.int32),
                        max_new=3) for i in range(2)]
        eng = ServingEngine(model, ServeConfig(max_len=16, page_tokens=4),
                            device="cpu")
        assert eng.desc.family == {"native": "mla" if cfg.mla else "dense",
                                   "int8": "int8"}[kd]
        eng.generate(reqs)
        assert all(len(r.generated) == 3 for r in reqs)

    # speculation, the prefix cache, the journal and a crash + recovery
    from repro_torch.core.engines import EngineSpec
    from repro_torch.serving import NGramProposer
    from repro_torch.serving.faults import CrashFault, FaultPlan
    from repro_torch.serving.journal import ServingJournal
    journal = ServingJournal()

    def features(plan=None):
        return ServingEngine(model, ServeConfig(
            max_len=16, page_tokens=4, speculate_k=2,
            draft_proposer=NGramProposer(), journal=journal,
            fault_plan=plan, engine_spec=EngineSpec(
                engine="paged", prefix_cache_tokens=64)), device="cpu")

    prompt = np.arange(6, dtype=np.int32)
    reqs = [Request(rid=i, prompt=prompt, max_new=4) for i in range(2)]
    try:
        features(FaultPlan(crash_at_tick=2)).generate(reqs)
    except CrashFault:
        reqs = [Request(rid=i, prompt=prompt, max_new=4) for i in range(2)]
        features().recover(reqs)
    else:
        raise AssertionError("the fault plan did not crash the run")
    assert all(len(r.generated) == 4 for r in reqs)

    # the dense mirror through the host-tier engines, fused and unfused
    model = LM(get_config("internlm2-1.8b-smoke"), device="cpu").init(
        torch.Generator().manual_seed(0))
    for name in ("log", "kvhybrid", "paged"):
        for fuse in (True, False):
            reqs = [Request(rid=i, prompt=prompt, max_new=3)
                    for i in range(2)]
            eng = ServingEngine(model, ServeConfig(
                max_len=16, page_tokens=4, paged_decode=False,
                fuse_ticks=fuse, prefill_chunk_tokens=4,
                engine_spec=EngineSpec(engine=name, drain_shards=2)),
                device="cpu")
            eng.generate(reqs)
            assert not eng.pooled and eng.stats()["mirror_d2h_bytes"] > 0
            assert all(len(r.generated) == 3 for r in reqs)

    # the state-space families: Mamba-2 on pooled state rows (and the
    # fused mirror), Zamba2 on the unfused mirror
    for arch in ("mamba2-1.3b-smoke", "zamba2-1.2b-smoke"):
        model = LM(get_config(arch), device="cpu").init(
            torch.Generator().manual_seed(0))
        for name in ("paged", "log"):
            reqs = [Request(rid=i, prompt=prompt, max_new=3)
                    for i in range(2)]
            eng = ServingEngine(model, ServeConfig(
                max_len=16, page_tokens=4, prefill_chunk_tokens=4,
                engine_spec=EngineSpec(engine=name, drain_shards=2)),
                device="cpu")
            eng.generate(reqs)
            assert eng.pooled == (arch.startswith("mamba") and
                                  name == "paged")
            assert eng.stats()["mirror_d2h_bytes"] == 0
            assert all(len(r.generated) == 3 for r in reqs)

    # a prompt past chunk_size: prefill through flash_attention
    cfg = get_config("internlm2-1.8b-smoke")
    model = LM(cfg, device="cpu", chunk_size=8).init(
        torch.Generator().manual_seed(0))
    reqs = [Request(rid=0, prompt=np.arange(20, dtype=np.int32), max_new=3)]
    ServingEngine(model, ServeConfig(max_len=32, page_tokens=4),
                  device="cpu").generate(reqs)
    assert len(reqs[0].generated) == 3

    # MLA past chunk_size: prefill through flash_attention at the (qk, v)
    # width pair, on both DeepSeek-V2 configs
    for arch in ("deepseek-v2-236b-noexperts-smoke",
                 "deepseek-v2-236b-smoke"):
        model = LM(get_config(arch), device="cpu", chunk_size=8).init(
            torch.Generator().manual_seed(0))
        reqs = [Request(rid=0, prompt=np.arange(20, dtype=np.int32),
                        max_new=3)]
        ServingEngine(model, ServeConfig(max_len=32, page_tokens=4),
                      device="cpu").generate(reqs)
        assert len(reqs[0].generated) == 3

    # the encoder-decoder and the VLM at model level: prefill past
    # chunk_size with their frontend embeddings, then decode steps
    for arch, n_front in (("seamless-m4t-large-v2-smoke", 24),
                          ("llava-next-mistral-7b-smoke", 16)):
        cfg = get_config(arch)
        model = LM(cfg, device="cpu", chunk_size=8).init(
            torch.Generator().manual_seed(0))
        width = cfg.d_model if cfg.family == "encdec" else \
            cfg.frontend.d_frontend
        logits, cache = model.prefill(
            torch.arange(12)[None], 32,
            frontend_embeds=torch.randn(1, n_front, width))
        for _ in range(2):
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            logits, cache = model.decode_step(cache, nxt, cache["pos"])
        assert bool(torch.isfinite(logits).all())

    # every public kernel entry, on CPU tensors (their plain versions)
    import repro_torch.kernels as K
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    tbl = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    lens = torch.tensor([3, 6], dtype=torch.int32)
    qls = torch.tensor([1, 2], dtype=torch.int32)
    pk, pv = r(2, 4, 4, 2, 32), r(2, 4, 4, 2, 32)
    ks = torch.rand(2, 4, 4, 2, generator=g).to(torch.bfloat16)
    k8 = (pk * 40).to(torch.int8)
    outs = [
        K.flash_attention(r(1, 6, 4, 32), r(1, 6, 2, 32), r(1, 6, 2, 32)),
        K.flash_attention(r(1, 6, 4, 48), r(1, 6, 4, 48), r(1, 6, 4, 32),
                          causal=False),
        K.log_patch(r(4, 4, 8), r(3, 8), torch.tensor([0, 1, 5]),
                    torch.tensor([0, 3, 1])),
        K.paged_attention_layers(r(2, 2, 4, 32), pk, pv, tbl, lens),
        K.paged_attention_layers_ragged(r(2, 2, 2, 4, 32), pk, pv, tbl,
                                        lens, qls),
        K.paged_attention_layers_ragged_q8(r(2, 2, 2, 4, 32), k8, k8, ks, ks,
                                           tbl, lens, qls),
        K.mla_paged_attention_layers_ragged(
            r(2, 2, 2, 4, 32), r(2, 2, 2, 4, 16), r(2, 4, 4, 32),
            r(2, 4, 4, 16), tbl, lens, qls, scale=0.2)]
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    assert sum(e.launches for e in K.COUNTED) == 0
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "repro" or m.startswith("repro."))
    print("LOADED:", bad)
    sys.exit(1 if bad else 0)
""")


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED: []" in proc.stdout


_LOADED = """
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("LOADED:", bad, file=sys.stderr)
sys.exit(1 if bad else 0)
"""

_FS_SCRIPT = textwrap.dedent("""
    import sys
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import ENGINES, PAGE_SIZE, EngineSpec, NVCacheFS

    # an NVCacheFS round trip, through a crash, on every FS engine
    for name in ENGINES:
        fs = NVCacheFS(EngineSpec(engine=name, nvmm_bytes=1 << 20,
                                  dram_cache_bytes=1 << 18))
        fd = fs.open("/f")
        fs.pwrite(fd, b"\\xAA" * PAGE_SIZE, 0)
        fs.pwrite(fd, b"tiny", PAGE_SIZE + 3)
        fs.fsync(fd)
        fs.crash()
        fs.recover()
        fd = fs.open("/f")
        assert fs.pread(fd, PAGE_SIZE, 0) == b"\\xAA" * PAGE_SIZE
        assert fs.pread(fd, 4, PAGE_SIZE + 3) == b"tiny"
        assert fs.stats()["sim_time_s"] > 0

    # a CheckpointManager save and restore on each design
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(64, 33, generator=g).to(torch.bfloat16),
            "b": {"n": torch.arange(7, dtype=torch.int32)}}
    for design in ("paged", "log", "nvhybrid"):
        mgr = CheckpointManager(design, nvmm_bytes=1 << 20)
        mgr.save(1, tree)
        mgr.crash()
        step, out = mgr.restore({"w": torch.zeros(64, 33,
                                                  dtype=torch.bfloat16),
                                 "b": {"n": torch.zeros(7,
                                                        dtype=torch.int32)}})
        assert step == 1 and torch.equal(out["w"], tree["w"])
        assert torch.equal(out["b"]["n"], tree["b"]["n"])
""") + _LOADED

_CLI_SCRIPT = textwrap.dedent("""
    import runpy
    import sys
    sys.argv = ["repro_torch.core.engines", "--list"]
    try:
        runpy.run_module("repro_torch.core.engines", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        assert not e.code, e.code
""") + _LOADED


def test_fs_tier_and_checkpoints_load_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _FS_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED: []" in proc.stderr


def test_engines_cli_loads_no_jax_and_lists_as_the_reference():
    """``python -m repro_torch.core.engines --list`` loads neither JAX nor
    ``repro``, and prints the reference's listing line for line (the FS
    engines, the KV engines, the family matrix), but for the package
    name."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _CLI_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED: []" in proc.stderr
    listed = {}
    for pkg in ("repro_torch", "repro"):
        run = subprocess.run([sys.executable, "-m", f"{pkg}.core.engines",
                              "--list"], env=env, capture_output=True,
                             text=True, timeout=120)
        assert run.returncode == 0, run.stderr
        listed[pkg] = run.stdout.replace(pkg + ".", "<pkg>.").splitlines()
    assert proc.stdout.splitlines() == listed["repro_torch"]
    assert listed["repro_torch"] == listed["repro"]
    names = [line.split()[0] for line in listed["repro_torch"][:8]]
    assert names == ["nvpages", "nvlog", "psync", "psync_fsync", "nvhybrid",
                     "paged", "log", "kvhybrid"]
    assert "support matrix" in listed["repro_torch"][9]


_TRAIN_SCRIPT = textwrap.dedent("""
    import runpy
    import sys
    sys.argv = ["repro_torch.launch.train", "--device", "cpu", "--arch",
                "internlm2-1.8b-smoke", "--steps", "3", "--seq", "64",
                "--ckpt-every", "2"]
    runpy.run_module("repro_torch.launch.train", run_name="__main__",
                     alter_sys=True)
""") + _LOADED

_EXAMPLE_SCRIPT = textwrap.dedent("""
    import runpy
    import sys
    sys.argv = ["train_lm_torch.py", "--device", "cpu", "--steps", "2",
                "--layers", "1", "--batch", "2", "--seq", "16"]
    try:
        runpy.run_path(sys.argv_path, run_name="__main__")
    except SystemExit as e:
        assert not e.code, e.code
""").replace("sys.argv_path", repr(str(SRC.parent / "examples" /
                                        "train_lm_torch.py"))) + _LOADED


def test_training_cli_and_example_load_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for script, expect in ((_TRAIN_SCRIPT, "ckpt[log] step 2"),
                           (_EXAMPLE_SCRIPT, "tok/s on CPU")):
        proc = subprocess.run([sys.executable, "-c", script], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "LOADED: []" in proc.stderr
        assert expect in proc.stdout, proc.stdout


def test_training_cli_and_example_default_to_the_gpu():
    """Without ``--device cpu`` both ask for the card, and raise when torch
    sees none (here)."""
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a GPU is present: the runs would go ahead")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for argv in (["-m", "repro_torch.launch.train", "--steps", "1"],
                 [str(SRC.parent / "examples" / "train_lm_torch.py"),
                  "--steps", "1", "--layers", "1"]):
        proc = subprocess.run([sys.executable, *argv], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert "device='cuda' requested but torch sees no GPU" in \
            proc.stderr, proc.stderr


_DRYRUN_SCRIPT = textwrap.dedent("""
    import os
    import runpy
    import sys
    import tempfile
    os.environ["REPRO_TEST_MESH"] = "2x2"
    import repro_torch.roofline.analysis
    sys.argv = ["repro_torch.launch.dryrun", "--device", "cpu", "--arch",
                "deepseek-v2-236b-smoke", "--shape", "train_4k", "--out",
                tempfile.mkdtemp()]
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__",
                     alter_sys=True)
""") + _LOADED

_TWINS_SCRIPT = textwrap.dedent("""
    import runpy
    import sys
    for name, argv in (("quickstart_torch.py", []),
                       ("crash_recovery_demo_torch.py", []),
                       ("serve_kv_offload_torch.py", ["--device", "cpu"])):
        sys.argv = [name, *argv]
        runpy.run_path(sys.examples_dir + "/" + name, run_name="__main__")
""").replace("sys.examples_dir", repr(str(SRC.parent / "examples"))) + \
    _LOADED


def test_dryrun_and_example_twins_load_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for script, expect in ((_DRYRUN_SCRIPT, "[ok] deepseek-v2-236b-smoke"),
                           (_TWINS_SCRIPT, "all 3 registered KV designs")):
        proc = subprocess.run([sys.executable, "-c", script], env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "LOADED: []" in proc.stderr
        assert expect in proc.stdout, proc.stdout


def test_dryrun_cli_and_serving_twin_default_to_the_gpu():
    """Without ``--device cpu`` the dry-run CLI and the serving twin ask
    for the card, and raise when torch sees none (here)."""
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a GPU is present: the runs would go ahead")
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_TEST_MESH="2x2")
    for argv in (["-m", "repro_torch.launch.dryrun", "--arch",
                  "internlm2-1.8b-smoke", "--shape", "decode_32k"],
                 [str(SRC.parent / "examples" /
                      "serve_kv_offload_torch.py")]):
        proc = subprocess.run([sys.executable, *argv], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert "device='cuda' requested but torch sees no GPU" in \
            proc.stderr, proc.stderr
