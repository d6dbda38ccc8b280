"""The port stands alone: serving through it — dense, int8 and MLA cache
families, the MoE configs (DeepSeek-V2 with its experts, Arctic), an
ungated FFN (StarCoder2) and the state-space families (Mamba-2 on its
state rows, the Zamba2 hybrid), with speculative decode, a prefix cache, a
token journal and a fault plan (a crash, then recovery), dense and MLA
prompts longer than ``chunk_size`` (the flash-attention prefill), and the
dense mirror through the ``log`` and ``kvhybrid`` engines and host-mode
``paged`` — the encoder-decoder and VLM configs at model level (prefill
with frontend embeddings, decode steps), and every public kernel entry
load neither JAX nor any module of the JAX package."""
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
    assert sum(e.launches for e in K.ENTRIES) == 0
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
