#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero, with
no result line, without them or outside a checkout of the repo. Phases —
each raises on failure, and any failure ends the run with a traceback:

1. env        — torch/CUDA/nvcc versions and the card; builds every
                kernel source (one ``nvcc`` per source, all started
                together), keeps each source's ``ptxas -v`` output in
                ``build/kernels/ptxas/`` and logs the main-path kernels'
                registers and spills.
2. kernels    — each kernel at the main paths' shapes in its working
                dtypes, held against its plain PyTorch version (a bf16
                output also against the plain fp32 version on the same
                inputs, to half a bf16 ulp), the bitwise pins (padding
                slots and q_len=0 rows are 0, dead slots change nothing
                (MLA: NaN-poisoned too, and a route flipped by the table's
                width — split-KV against the in-block fold — where one
                flips),
                ragged at q_len=1 is the decode entry, layer l of a
                multi-layer launch is the single-layer launch on layer l),
                and CUDA-event times beside the bound and a library call
                (for the dense and int8 paged entries also the whole
                function in PyTorch calls: gather, dequantize, SDPA, and
                the split-KV scratch bytes; for MLA the scratch bytes and
                the route, split or in-block, and the bound at the fp32
                rate beside the bf16 pool's tensor-core bound). Each time
                is taken twice:
                host-paced (``ms``: the loop enqueued as the card runs
                it) and card-only (``card_ms``: enqueued while the card
                sleeps).
                Dense and int8: B=8, H=16, K=8, D=128, T=16, MP=64, Qmax
                128 and 1, one layer and L=24; the dense ragged and decode
                entries also at the head shapes of phases 18-19's configs,
                (H, K, D) = (56, 8, 128) Arctic, (48, 4, 128) StarCoder2,
                (16, 16, 256) Gemma, (36, 36, 64) MiniCPM; MLA: B=8,
                H=128, dc=512, dr=64, T=16, MP=64, Qmax 128 (the MLA serve
                phase's prefill chunk) and 1, one layer and L=8; flash
                attention: one InternLM2-1.8B layer of a 4096-token
                prefill (B=1, H=16, K=8, D=128, causal), one Zamba2-1.2B
                shared-attention block (H=K=32, D=64, causal) at 1100
                and 4096 tokens, phases 24-29's shapes (``FLASH_SHAPES``:
                DeepSeek-V2's MLA prefill, H=K=128 at qk width 192 and v
                width 128, causal at 4096 and 1100 tokens; Seamless-M4T
                v2's encoder, 16/16/64 non-causal at 4096 x 4096, its
                cross-attention at 600 x 4096 and 1 x 4096; LLaVA-NeXT's
                prefill, 32/8/128 causal at 2880 + 64 tokens), and the
                JAX package's test cases, with a causal Sq > Skv case
                whose dead rows are 0;
                log patch: P=682, T=16, C=2048 (K and V of one token in
                one InternLM2-1.8B layer), N=256 records with colliding
                targets, skipped records and out-of-range indices, bit for
                bit the plain version, with the copy route it took (vector
                or scalar);
                the paged K/V write (no pallas_call: it replaces the JAX
                package's XLA scatter, ``SCATTERS``): a chat tick, 64 rows
                at Qmax 128 (61 decode rows, 3 chunks) into one layer's
                planes of a 16384-page pool, bf16 K/V (8 x 128), int8
                codes and bf16 scales, DeepSeek-V2's latent and rope key,
                two table entries of -1 and P; bit for bit the
                boolean-index write over the whole pool, timed against it
                and ``index_put_``. Each entry that no serving path
                calls (the multi-layer entries and log patch, as in the
                JAX package) is then called once more through
                ``repro_torch.kernels`` with the launch counts set to 0
                just before and read just after: its public-entry run.
3. serve      — full-width InternLM2-1.8B (random weights from --seed) in
                bf16 through ``ServingEngine.generate()``, pooled and
                fused: 8 requests, prompts of 64–512 tokens, 32 new tokens
                each, 1 GiB pool.
4. parity     — full width in fp32: ``generate()`` against the dense
                ``generate_sequential()``; then a 4-layer tight-pool run
                that must preempt and stay token-identical.
5. unfused    — the 4-layer run with ``fuse_ticks=False``: prompt chunks
                go token by token through the decode kernel.
6. serve-int8 — phase 3 with an int8 KV pool (int8 K/V, bf16 scales) at
                the same 1 GiB: about twice the pages.
7. parity-int8 — phases 4 and 5 with the int8 pool, against the int8
                sequential reference with the pooled path's prompt split
                (first chunk prefilled, the rest through the decode step):
                a chunked int8 prompt attends over quantized K/V of its
                earlier chunks, which one-shot prefill does not.
8. serve-mla  — DeepSeek-V2 without experts (MLA, d_ff 12288 FFN in every
                layer) at full width and depth (60 layers) in bf16,
                phase 3's requests.
9. parity-mla — 4 layers of it at full width in fp32: fused and unfused
                runs token-identical to ``generate_sequential()``.
10. serve-spec — phase 3 with speculative decode: ``speculate_k = 4``
                draft tokens a decode row from the n-gram proposer, so
                decode rows run the ragged kernel at Qmax 8.
11. parity-spec — 4 layers at full width in fp32, dense, int8 and MLA:
                speculative ``generate()`` (drafts from the reference's
                own continuation, corrupted from the third on, so every
                decode tick accepts some drafts and rolls the rest back)
                token-identical to the sequential reference (int8: the
                chunk-aware one).
12. serve-prefix — full-width InternLM2-1.8B in bf16: 8 requests share a
                384-token prefix, each with its own 32–256-token tail;
                the first publishes the prefix, the other 7 splice it
                from the prefix cache (4096 tokens) and prefill only
                their tails; the same requests without the cache for
                comparison. Then a 4-layer fp32 run on a pool tight
                enough to preempt, with duplicates that copy-on-write
                their shared boundary page: token-identical.
13. crash-recover — 4 layers at full width in fp32: a journaled run
                crashed at a mid-run tick by a scripted fault plan and
                recovered by a fresh engine sharing the journal; then an
                unfused run on a tight pool whose spilled pages come back
                lost (``page_loss_rate``) and whose transfers fail and
                stall (async tiering). Both token-identical to the
                uninterrupted sequential reference.
14. serve-long — full-width InternLM2-1.8B in bf16, whole-prompt prefill
                (no prefill chunks) of prompts of 4096, 3072, 2048 and
                1100 tokens through the flash-attention kernel, 32 new
                tokens each, 2 GiB pool: one flash launch per layer and
                prompt.
15. parity-long — full width in fp32, prompts of 1100 and 2048 tokens, 8
                new tokens: ``generate()`` against
                ``generate_sequential()``; then ``LM.prefill`` of the
                2048-token prompt through the flash kernel against the
                same model's plain ``full_attention`` branch (last logits
                and every layer's K/V, fp32 tolerance).
16. serve-log, serve-kvhybrid, serve-paged-mirror — phase 3's requests
                through the dense mirror on the ``log`` and ``kvhybrid``
                engines and host-mode ``paged`` (``paged_decode=False``):
                plain torch attention over the rows, no kernel entry
                launched; the new tokens mirrored into the host tiers
                (every computed token lands there), the wall split into
                the mirror calls and their host-tier appends.
17. parity-mirror — 4 layers at full width in fp32: dense on all three
                engines, fused and unfused, int8 (chunk-aware reference)
                and MLA on ``log``, ``log`` with speculation and on a
                hot-window budget that preempts (``MIRROR_TIGHT``), each
                token-identical to the pooled ``generate()`` and the
                sequential reference, no kernel launched.
18. serve-deepseek-moe, serve-arctic, serve-gemma, serve-minicpm,
                serve-starcoder2 — phase 3's workload (bf16, random
                weights from --seed, 1 GiB pool, pooled and fused) at each
                config's published widths: DeepSeek-V2 with its 160
                routed and 2 shared experts cut to 8 of 60 layers (1 dense
                + 7 MoE; the MLA kernel), Arctic cut to 2 of 35 layers (128
                experts, GQA group 7), both at the published capacity
                factor 1.25; Gemma-7B (head_dim 256), MiniCPM-2B
                (head_dim 64) and StarCoder2-15B (GQA group 12, ungated
                GELU) at full depth. Each model is freed before the next.
19. parity-families — fp32 at published widths: DeepSeek-V2 at 3 layers
                (1 dense + 2 MoE) and Arctic at 1 layer, both at no-drop
                capacity (capacity factor = expert count; at 1.25 a
                token's output depends on its batch, in the JAX package
                too), and each dense config at 4 layers: ``generate()``
                token-identical to ``generate_sequential()``.
20. serve-mamba2 — Mamba-2 1.3B (48 layers, published widths, bf16,
                random weights from --seed) through phase 3's workload on
                ``paged`` at 1 GiB: pooled, fused, mirror-free; its cache
                is one state row per sequence (97.2 MiB) beside the block
                tables, and no kernel entry runs (the reference's SSD scan
                is XLA, no Pallas).
21. serve-zamba2 — Zamba2-1.2B (all 38 layers, bf16) on ``paged``, where
                it falls back to the unfused dense mirror (no cache
                descriptor, as in the reference), prompts of 4096, 3072,
                2048, 1100, 256 and 64 tokens prefilled whole: each prompt
                past 512 tokens runs flash attention once per
                shared-block invocation (6).
22. parity-ssm — fp32 Mamba-2 at published widths cut to 4 layers: pooled
                ``generate()`` with 5-token chunks, ``speculate_k`` 2 and a
                2-row state budget that preempts, token-identical to
                ``generate_sequential()``.
23. parity-hybrid — fp32 Zamba2 cut to 14 layers (2 segments, both shared
                blocks, a tail of 2), a 1100-token prompt among three:
                ``generate()`` token-identical to
                ``generate_sequential()``.
24. serve-mla-long — phase 14 on DeepSeek-V2 without experts (60 layers,
                bf16): prompts of 4096 to 1100 tokens prefilled whole
                through #9 at MLA's (192, 128) widths, once a layer and
                prompt, then decode through #7 on the latent pool.
25. parity-mla-long — phase 15 on it in fp32 at 4 layers: ``generate()``
                against ``generate_sequential()``, then the 2048-token
                ``LM.prefill`` through #9 against the plain branch (last
                logits and every layer's ``c``/``kr``).
26. model-encdec — Seamless-M4T v2 at published widths (24 encoder + 24
                decoder layers, bf16), B = 1, 4096 frames of width 1024
                and a 64- and a 600-token text prompt: ``LM.prefill`` (#9
                non-causal in the encoder and the cross-attention, causal
                in the decoder past 512 tokens) and 32 greedy
                ``decode_step``s (#9 at Sq = 1 over the 4096 frames, once
                a layer). Model level: neither package serves it.
27. model-vlm — LLaVA-NeXT-Mistral-7B at published widths (32 layers,
                bf16), 2880 image patches of width 1024 through the
                projector before 64 text tokens: one 2944-token causal #9
                a layer, then 32 greedy decode steps (no kernel).
28. parity-encdec, 29. parity-vlm — fp32, 4 (+ 4 encoder) layers at
                published widths, phases 26-27's inputs: prefill through
                #9 against the plain branch (last logits, every layer's
                K/V and, for Seamless, cross K/V), then 8 greedy decode
                steps token-identical to the plain branch's.
30. fs-matrix — the paper's Fig. 3/4 fio grid on the port's ``NVCacheFS``
                (host code, this script's copy of the reference's fio
                runner) at its default 32 MiB file, one run a cell:
                8 workloads x {nvpages, nvlog, psync, nvhybrid} at small
                (file/10) and large (5 x file) NVMM, and psync_fsync's
                randw job at 1/8 size; every cell's simulated seconds
                (the reference's modelled Optane/NVMe clock, not a speed of
                the port) and the paper checks, printed.
31. ckpt-paged, ckpt-log, ckpt-nvhybrid — full-width InternLM2-1.8B (all
                24 layers, bf16, random weights from --seed, 3.78 GB) on
                the card saved through ``CheckpointManager`` at its
                default 1 GiB of NVMM (paged: nvpages; log: nvlog, then a
                delta step of the final norm and ``head``, edited on the
                card; nvhybrid), crashed, restored onto a second model
                from another seed on the card, bit for bit, and serving
                the same 8 greedy tokens for the serve phase's first two
                requests as the saved model; save and restore wall and
                simulated seconds, GB/s, the FS stats and peak RSS.
32. train     — full-width InternLM2-1.8B (24 layers, bf16 weights, fp32
                AdamW masters, per-layer remat, random weights and
                synthetic data from --seed) through the training CLI,
                ``repro_torch.launch.train.main``: 8 steps of 4 x 2048
                tokens, #9 forward under its autograd Function in every
                layer and again in its remat recompute (the launch counts
                set to 0 just before, read just after: 24 x 2 x 8); every
                step's loss finite, step 0's loss within 1e-2 of the same
                weights' loss with the plain attention in the kernel's
                place; step ms (the first apart), tokens/s, peak memory,
                and the optimizer's and the plain attention backward's
                share of a step (each timed alone on the card).
33. parity-train — fp32: InternLM2-1.8B's widths cut to 4 layers and
                DeepSeek-V2 without experts (MLA, #9 at (192, 128)) cut to
                2 layers, one 1024-token sequence each: the kernel path's
                loss within 1e-5 relative and each gradient leaf's max
                |diff| within 1e-3 of its max |g| of the plain path's
                (``flash_attention_ref`` differentiated by autograd), the
                worst leaf printed.
34. train-crash — ``examples/train_lm_torch.py`` on the card in its own
                process (the reference example's internlm2-100m, fp32,
                batch 16 x 256 tokens: no kernel), deterministic
                algorithms on: 30 steps (the example's 200 cut to fit the
                time limit), NVLog saves at 10 and 20, a crash at 25, the
                restore checked bit for bit against the step-20 state,
                steps 21-25 replayed with the first run's losses bit for
                bit, then on to 30; save and restore wall and simulated
                seconds and the process's peak RSS.

35. dryrun    — the port's dry run (``repro_torch.launch.dryrun.run_cell``)
                on fake CUDA tensors at full width over a fake 256-rank
                world, the (16, 16) pod mesh: InternLM2-1.8B x train_4k
                (at 2 layers), prefill_32k and decode_32k; DeepSeek-V2 x
                train_4k at 2 layers (expert parallelism and MLA); Mamba-2
                1.3B and Zamba2-1.2B x decode_32k; and InternLM2-1.8B x
                train_4k at 2 layers on the 512-rank (2, 16, 16) multipod
                mesh. The train cells run at the roofline's sample depth
                (at the whole depth they took two thirds of the phase).
                Each cell's per-rank live GB, fits-HBM,
                collectives and wire bytes, flops and seconds; the H100
                record's 80 GB beside the card's ``total_memory``.
36. dryrun-card — a real one-card mesh (``nccl``, world 1, mesh (1, 1)):
                InternLM2-1.8B at full width cut to 2 layers, bf16, its
                weights DTensors placed by the sharding rules; one
                train_4k step at global batch 4 and one prefill_32k at
                batch 1 (#9 through its custom op on DTensors), each
                against the same weights as plain tensors (loss, last
                logits: bit for bit, or within fp32 tolerance, and which);
                the dry run's predicted per-rank live bytes and flops of
                the same cut cells at (1, 1) beside
                ``torch.cuda.max_memory_allocated`` (their ratio must lie
                in ``CARD_PEAK_BAND``) and the plain run's
                ``FlopCounterMode`` count.
37. ep-card   — one DeepSeek-V2 MoE layer at full width (160 routed
                experts, 2 shared, d 5120, hidden 1536, bf16) on the (1, 1)
                mesh: ``_moe_ep`` at 8192 tokens and
                ``_moe_ep_tokengather`` at 64, each through ``apply_moe``
                on DTensors against the single-device ``apply_moe`` on
                plain tensors (outputs and aux), with each path's ms.
38. examples  — ``examples/serve_kv_offload_torch.py`` on the card in its
                own process; its asserts (pooled == sequential for every
                registered KV engine, the int8/SSM family sweep, crash and
                recover) are the gate.

Each serving path is driven with the launch counts set to 0 just before
it and read just after (every entry of ``repro_torch.kernels.COUNTED``,
the K/V write too, which must launch once a paged attention launch: each
layer of a paged step writes, then attends); a row's ``serving_launches``
is the sum of its entry's counts over those runs (0 for an entry only its
public-entry run calls). The last lines are the card's name and power
limit, a ``{"kernels": ...}`` JSON line, and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if (ROOT / "src" / "repro_torch").is_dir():   # else main() refuses to run
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.roofline.hw import H100
    # H100 SXM peaks (``repro_torch.roofline.hw.H100``, NVIDIA's data
    # sheet, dense): HBM3 bytes/s, and flop/s for each operand type — bf16
    # on the tensor cores (exact products, fp32 accumulation), fp32
    # outside them, and fp32 on the tensor cores as 3xTF32: three TF32
    # products a fp32 product
    HBM_BYTES_PER_S = H100.hbm_bandwidth
    FLOPS_PER_S = {"bfloat16": H100.peak_flops_bf16,
                   "float32": H100.peak_flops_fp32,
                   "tf32x3": H100.peak_flops_tf32 / 3}
# kernel vs its plain version on the same inputs (tests/test_kernels.py)
TOL = {"float32": (1e-4, 4e-5), "bfloat16": (1e-1, 4e-2)}
# bf16 kernel output vs the plain fp32 version on the same values: the
# kernel's math is fp32, so only the output's rounding to bf16 (at most
# half an ulp, 2^-8 relative) may differ. Accumulating in bf16, or
# dropping part of a row, fails this.
TOL_BF16_VS_FP32 = (1e-5, 2 ** -8)
KERNEL_PY = "src/repro/kernels/paged_attention/kernel.py"
CSRC = "src/repro_torch/kernels/paged_attention/csrc/"
PAGED_CU = CSRC + "paged_attention.cu"
MLA_CU = CSRC + "mla_paged_attention.cu"
# row name → (TPU kernel's pallas_call line, CUDA source)
KERNELS = {
    "paged_attention_ragged": (f"{KERNEL_PY}:321", PAGED_CU),
    "paged_attention": (f"{KERNEL_PY}:126", PAGED_CU),
    "paged_attention_layers": (f"{KERNEL_PY}:211", PAGED_CU),
    "paged_attention_layers_ragged": (f"{KERNEL_PY}:373", PAGED_CU),
    "paged_attention_ragged_q8": (f"{KERNEL_PY}:481", PAGED_CU),
    "paged_attention_layers_ragged_q8": (f"{KERNEL_PY}:539", PAGED_CU),
    "mla_paged_attention_ragged": (f"{KERNEL_PY}:637", MLA_CU),
    "mla_paged_attention_layers_ragged": (f"{KERNEL_PY}:684", MLA_CU),
    "flash_attention": (
        "src/repro/kernels/flash_attention/kernel.py:104",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"),
    "log_patch": ("src/repro/kernels/log_patch/kernel.py:70",
                  "src/repro_torch/kernels/log_patch/csrc/log_patch.cu"),
}
# row name → (the JAX package's XLA scatter it replaces, CUDA source): the
# port's kernels with no pallas_call behind them
SCATTERS = {
    "kv_page_write": ("src/repro/models/attention.py:403",
                      CSRC + "kv_page_write.cu"),
}
ROWS = {**KERNELS, **SCATTERS}
# the K/V write's launches; each layer of a paged step writes once, then
# launches one of these single-layer entries
WRITE = "kv_page_write"
STEP_ENTRIES = ("paged_attention_ragged", "paged_attention",
                "paged_attention_ragged_q8", "paged_attention_q8",
                "mla_paged_attention_ragged", "mla_paged_attention")
GEOM = dict(B=8, H=16, K=8, D=128, T=16, MP=64)
# the (H, K, D) the configs of phases 18-19 give the dense paged entries
# (GQA groups 7, 12 and 1; head_dim 256 and 64), at GEOM's B, T and MP
CONFIG_GEOMS = {"arctic-480b": (56, 8, 128), "starcoder2-15b": (48, 4, 128),
                "gemma-7b": (16, 16, 256), "minicpm-2b": (36, 36, 64)}
MLA_GEOM = dict(B=8, H=128, dc=512, dr=64, T=16, MP=64)
CHUNK = 128                  # serve phases' prefill chunk = kernel Qmax
SPEC_K = 4                   # draft tokens a decode row: Qmax bucket 8
PREFIX_TOKENS = 384          # serve-prefix's shared prompt head
PREFIX_MAX_LEN = 688         # the head, a 256-token tail and 32 new tokens
LAYERS, MLA_LAYERS = 24, 8   # depth of the multi-layer kernel cases
# one InternLM2-1.8B layer of a 4096-token prefill
FLASH_GEOM = dict(B=1, Sq=4096, Skv=4096, H=16, K=8, D=128, DV=128,
                  causal=True)
# (H, K, D) of Zamba2-1.2B's shared attention blocks (MHA), and the prompt
# lengths phase 2 runs #9 there at
ZAMBA2_FLASH = (32, 32, 64)
ZAMBA2_FLASH_S = (1100, 4096)
# #9 at phases 24-29's shapes: DeepSeek-V2's MLA prefill (qk width 192, v
# width 128, 128 heads) at serve-mla-long's longest and shortest prompts;
# Seamless-M4T v2's encoder over 4096 frames, its cross-attention from a
# 600-token prompt and from one decode step (16/16/64, non-causal); and
# LLaVA-NeXT-Mistral-7B's prefill of 2880 image and 64 text tokens
# (32/8/128, causal): (what, Sq, Skv, H, K, D, DV, causal)
FLASH_SHAPES = [
    ("deepseek-v2-236b MLA", 4096, 4096, 128, 128, 192, 128, True),
    ("deepseek-v2-236b MLA", 1100, 1100, 128, 128, 192, 128, True),
    ("seamless-m4t-large-v2 encoder", 4096, 4096, 16, 16, 64, 64, False),
    ("seamless-m4t-large-v2 cross", 600, 4096, 16, 16, 64, 64, False),
    ("seamless-m4t-large-v2 decode cross", 1, 4096, 16, 16, 64, 64, False),
    ("llava-next-mistral-7b", 2944, 2944, 32, 8, 128, 128, True),
]
# the JAX package's flash cases (tests/test_kernels.py), and one causal
# Sq > Skv case whose first 32 query rows see no key
# (B, Sq, Skv, H, K, D, causal)
FLASH_CHECKS = [(2, 128, 128, 8, 2, 64, True), (1, 100, 260, 4, 4, 32, True),
                (2, 64, 192, 6, 2, 128, False), (1, 256, 256, 4, 1, 128, True),
                (1, 37, 129, 2, 2, 256, True), (1, 48, 16, 2, 1, 32, True)]
# K and V of one token in one InternLM2-1.8B layer, the bf16 page count
# of a 1 GiB pool, one drain batch
LOG_GEOM = dict(P=682, T=16, C=2048, N=256)
# the K/V write at a chat tick (64 rows at Qmax 128: 61 decode rows, 3
# chunks) into one layer's planes of a B x MP = 16384-page pool
# (InternLM2-1.8B's layer share of a 25 GiB pool); each family's planes as
# (trailing shape, dtype): K and V of 8 heads of 128; int8 codes and their
# bf16 scales; DeepSeek-V2's latent (512) and rope key (64)
WRITE_GEOM = dict(B=64, Q=128, T=16, MP=256, chunk_rows=3)
WRITE_PLANES = {
    "bfloat16": [((8, 128), "bfloat16")] * 2,
    "int8": [((8, 128), "int8")] * 2 + [((8,), "bfloat16")] * 2,
    "mla": [((512,), "bfloat16"), ((64,), "bfloat16")],
}
# phase 32: the training CLI's run, and #9 at its shape (one layer of the
# 4 x 2048-token batch)
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 2048
TRAIN_FLASH = dict(B=TRAIN_BATCH, Sq=TRAIN_SEQ, Skv=TRAIN_SEQ, H=16, K=8,
                   D=128, DV=128, causal=True)
# phase 33: (arch, layers, sequence) of the fp32 training parity runs
PARITY_TRAIN = (("internlm2-1.8b", 4, 1024),
                ("deepseek-v2-236b-noexperts", 2, 1024))
# phase 34: the example's steps (200 by default) and crash; it saves every
# 10 steps, so the restore goes back to step 20
CRASH_STEPS, CRASH_AT = 30, 25
CRASH_ARGS: list = []               # more example flags (none on the card)
LONG_PROMPTS = (4096, 3072, 2048, 1100)
# phase 35: the dry run's cells at full width on the fake 256-rank pod
# mesh (and one on the 512-rank multipod mesh): (arch, shape, multi_pod,
# layers — None: all; the train cells at the roofline sample depth, for
# the script's time)
DRYRUN_CELLS = (("internlm2-1.8b", "train_4k", False, 2),
                ("internlm2-1.8b", "prefill_32k", False, None),
                ("internlm2-1.8b", "decode_32k", False, None),
                ("deepseek-v2-236b", "train_4k", False, 2),
                ("mamba2-1.3b", "decode_32k", False, None),
                ("zamba2-1.2b", "decode_32k", False, None),
                ("internlm2-1.8b", "train_4k", True, 2))
# and a cell whose row-parallel Partial reached the NLL's local_map
# before the residual stream was settled (Gemma's tied table)
DRYRUN_SETTLED = (("gemma-7b", "train_4k", False, 2),)
# phase 36: the real one-card mesh's model (depth cut) and batches (cut:
# train_4k's 256 sequences to 4, prefill_32k's 32 to 1)
CARD_ARCH, CARD_LAYERS = "internlm2-1.8b", 2
CARD_BATCH = {"train_4k": 4, "prefill_32k": 1}
# the band that max_memory_allocated / the dry run's predicted live bytes
# must fall in: the allocator adds cuBLAS's workspace and its rounding on
# top of what the dry run counts (measured 1.001 train, 1.020 prefill on
# NVIDIA H100 80GB HBM3, 700.00 W; scripts/dryrun_memory_trace.py holds
# the two op by op)
CARD_PEAK_BAND = (0.95, 1.10)
# phase 37: one DeepSeek-V2 MoE layer; (EP path, tokens, capacity factor:
# no-drop = the expert count, or the published 1.25 where no-drop's
# dispatch buffer, experts x tokens·k x d, would not fit)
EP_ARCH = "deepseek-v2-236b"
EP_CASES = (("_moe_ep", 8192, 1.25), ("_moe_ep_tokengather", 64, None))
# GPU clock cycles the card sleeps before a timing loop (~25 ms at 1.98
# GHz): longer than the host takes to enqueue the loop
SLEEP_CYCLES = 50_000_000
# mangled names of the kernels the main paths run (bf16 or int8 pages, D
# 128 or MLA's 512, 16-token pages; flash at (128, 128), Seamless's (64,
# 64) and MLA's (192, 128), bf16), and of every instantiation of the fp32
# flash kernel (3xTF32) and of log patch (each dtype pair, both routes),
# whose registers phase 1 logs
MAIN_PATH_KERNELS = (
    r"paged_attention_part_kernelI13__nv_bfloat16(S1_|a)Li128ELi16EE"
    r"|paged_attention_combine_kernelI13__nv_bfloat16Li128EE"
    r"|flash_attention_mma_kernelILi(128ELi128|192ELi128|64ELi64)EE"
    r"|flash_attention_tf32x3_kernelILi\d+ELi\d+EE"
    r"|log_patch_kernelI\w+?Lb[01]EE"
    r"|mla_paged_attention_part_kernelI13__nv_bfloat16Li512EE"
    r"|mla_paged_attention_combine_kernelILi512EE"
    r"|kv_page_write_kernel")


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# --------------------------------------------------------------- phase 1
def phase_env(torch):
    from repro_torch.kernels.build import (NVCC_FLAGS, library_path,
                                           nvcc_path)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    nvcc = nvcc_path()
    log("[env] " + subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True
                                  ).stdout.strip().splitlines()[-1])
    log(f"[env] {smi_line()}")
    sources = sorted((ROOT / "src" / "repro_torch" / "kernels").glob(
        "*/csrc/*.cu"))
    t0 = time.time()
    procs = []
    for src in sources:          # one nvcc per source, all at once
        out = library_path(src)
        out.parent.mkdir(parents=True, exist_ok=True)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for src, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{text}")
        kernels = ptxas_kernels(text)
        out = library_path(src).parent / "ptxas" / f"{src.stem}.log"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text)
        spilling = [k for k in kernels if k["spill_stores"]]
        log(f"[env] built {src.relative_to(ROOT)}: {len(kernels)} kernels, "
            f"registers {min(k['regs'] for k in kernels)}-"
            f"{max(k['regs'] for k in kernels)}, {len(spilling)} spilling "
            f"(ptxas -v in {out.relative_to(ROOT)})")
        for k in kernels:        # the main paths' instantiations
            hit = re.search(MAIN_PATH_KERNELS, k["name"])
            if hit:
                log(f"[env]   {hit.group(0)}: {k['regs']} registers, "
                    f"{k['spill_stores']} B spill stores, "
                    f"{k['spill_loads']} B spill loads")
    log(f"[env] kernel build {time.time() - t0:.1f} s")


def ptxas_kernels(text):
    """Registers and spill bytes of each kernel in ``nvcc -Xptxas -v``
    output, by mangled name."""
    kernels, cur = [], None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            cur = {"name": ln.split("'")[1], "regs": 0, "spill_stores": 0,
                   "spill_loads": 0}
            kernels.append(cur)
        elif cur is not None and "spill stores" in ln:
            words = ln.replace(",", "").split()
            cur["spill_stores"] = int(words[words.index("spill") - 2])
            cur["spill_loads"] = int(words[-4])
        elif cur is not None and "Used" in ln and "registers" in ln:
            words = ln.split()
            cur["regs"] = int(words[words.index("registers,") - 1]
                              if "registers," in words
                              else words[words.index("registers") - 1])
    return kernels


# --------------------------------------------------------------- phase 2
def cuda_ms(torch, fn, iters, card_only=False):
    """Time per call of ``fn``: CUDA events around ``iters`` calls. By
    default the host enqueues the loop while the card runs it, so a call
    that the host takes longer to enqueue than the card to run reads as
    the host's time, as a serving loop feels it. With ``card_only`` the
    loop is enqueued while the card sleeps, and the events time the card's
    work alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if card_only:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def row_lengths(torch, dev, qmax):
    """Mixed lengths with a q_len=0 (or lengths=0) row."""
    if qmax == 1:
        q_lens = [0, 1, 1, 1, 1, 1, 1, 1]      # row 0: lengths == 0
        ctx = [0, 0, 15, 16, 300, 701, 1023, 64]
    else:
        q_lens = [0, 1, qmax, 57, 1, qmax, 3, 1]
        ctx = [5, 300, 0, 700, 1023, 512, 64, 17]
    q_lens = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    lengths = torch.tensor(ctx, dtype=torch.int32, device=dev) + q_lens
    return lengths, q_lens


def block_table(torch, g, dev, B, MP, P, T, lengths):
    """Distinct live pages per row, garbage table tails."""
    perm = torch.randperm(P, generator=g, device=dev)[:B * MP]
    table = perm.reshape(B, MP).to(torch.int32)
    for b in range(B):
        live = -(-int(lengths[b]) // T)
        table[b, live:] = torch.randint(-P, 3 * P, (MP - live,), generator=g,
                                        device=dev, dtype=torch.int32)
    return table


def dead_slots(torch, P, T, table, lengths):
    """(P, T) mask of every slot no row may see: past a row's length in
    its last live page, and whole pages past its live ones."""
    dead = torch.zeros((P, T), dtype=torch.bool)
    tbl = table.tolist()
    lives = [-(-int(n) // T) for n in lengths.tolist()]
    live_pages = {tbl[b][lp] for b, live in enumerate(lives)
                  for lp in range(live)}
    for b, live in enumerate(lives):
        n = int(lengths[b])
        if n % T:
            dead[tbl[b][live - 1], n % T:] = True
        for phys in tbl[b][live:]:
            if 0 <= phys < P and phys not in live_pages:
                dead[phys] = True
    return dead.to(table.device)


def sdpa(torch, q, k, v, lengths, q_lens, scale=None):
    """``F.scaled_dot_product_attention`` of q (B, Qm, H, D) over dense
    k/v (B, S, Kh, D), causal in the chunk (a yardstick only — the port
    never calls it)."""
    F = torch.nn.functional
    Qm = q.shape[1]
    S = k.shape[1]
    qpos = (lengths - q_lens).long()[:, None] + torch.arange(Qm,
                                                             device=q.device)
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True, scale=scale)


def gather(pool, table):
    """Pool pages (P, T, ...) through the clamped table → (B, S, ...)."""
    tbl = table.long().clamp(0, pool.shape[0] - 1)
    return pool[tbl].reshape((table.shape[0], -1) + pool.shape[2:])


class Case:
    """One kernel entry at one shape and dtype: its arguments, kernel and
    plain calls, the plain fp32 version's arguments (``args32``, None when
    the kernel must equal its plain version bit for bit: ``exact``), the
    pins its output must hold, the work it must do, a library yardstick
    (and, for the dense and int8 paged entries, ``library_gather``: the
    whole function in PyTorch calls, gather included), and — for an entry
    no serving path calls — the entry itself, called once more as its
    public-entry run."""
    exact = False
    args32 = None
    entry = None
    library_gather = None
    extra = {}                   # more fields for the row, logged as well
    iters = (20, 3, 10)          # kernel, plain, library timing loops

    def pins(self, out):
        pass


def paged_pins(torch, c, out):
    """The paged entries' bitwise pins on ``out`` ((L,) B, Qmax, ...):
    padding slots and q_len=0 rows are 0, poisoned dead slots change
    nothing, q_len=1 rows equal the decode entry, and layer l of a
    multi-layer launch is the single-layer launch on layer l."""
    for b, ql in enumerate(c.q_lens.tolist()):
        if not bool((out[..., b, ql:, :, :] == 0).all()):
            raise AssertionError(f"{c.label}: row {b} padding not 0")
    if not torch.equal(c.kern(*c.poisoned), out):
        raise AssertionError(f"{c.label}: dead slots changed the output")
    ones = (c.q_lens == 1).nonzero().flatten()
    if not torch.equal(out[..., ones, 0, :, :],
                       c.decode()[..., ones, 0, :, :]):
        raise AssertionError(f"{c.label}: ragged at q_len=1 != decode")
    for l in range(getattr(c, "layers", 0)):
        if not torch.equal(out[l], c.single(l)):
            raise AssertionError(f"{c.label}: layer {l} != the single-layer "
                                 f"entry")


def paged_work(lengths, q_lens, T, page_bytes, row_flops, fixed_bytes,
               layers=1):
    """(bytes, flops) of a paged call: each live page of each row with
    queries read once, queries and output once, over ``layers`` layers;
    ``row_flops(n, ql)`` is one row's work in one layer."""
    nbytes, flops = 0, 0
    for n, ql in zip(lengths.tolist(), q_lens.tolist()):
        if ql > 0:
            nbytes += -(-n // T) * page_bytes
            flops += row_flops(n, ql)
    return layers * nbytes + fixed_bytes, layers * flops


def dense_case(torch, dev, dtype, qmax, seed, q8=False, layers=None,
               geom=GEOM):
    """The dense or int8 paged entries at phase 2's shapes (``geom``): one
    layer, or ``layers`` layers through the multi-layer entries."""
    import repro_torch.kernels as K
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.models.attention import quantize_kv
    B, H, Kh, D, T, MP = (geom[k] for k in "B H K D T MP".split())
    P = B * MP + 64
    L = layers or 1
    g = torch.Generator(dev).manual_seed(seed)
    lengths, q_lens = row_lengths(torch, dev, qmax)
    table = block_table(torch, g, dev, B, MP, P, T, lengths)
    lead = (L,) if layers else ()
    q = torch.randn(lead + (B, qmax, H, D), generator=g, device=dev).to(dtype)
    pk = torch.randn(lead + (P, T, Kh, D), generator=g, device=dev)
    pv = torch.randn(lead + (P, T, Kh, D), generator=g, device=dev)
    dead = dead_slots(torch, P, T, table, lengths)
    at = (slice(None), dead) if layers else (dead,)
    c = Case()
    c.extra = {"scratch_bytes": 4 * ops.scratch_floats(L, B, qmax, H, Kh, D,
                                                       MP)}
    if q8:
        (pk, ks), (pv, vs) = quantize_kv(pk), quantize_kv(pv)
        planes = (pk, pv, ks, vs)
        poisoned = tuple(x.clone() for x in planes)
        poisoned[0][at], poisoned[1][at] = 127, -127
        poisoned[2][at], poisoned[3][at] = 1e6, 1e6
        kd, vd = (ref.dequant_pool(p, s).to(dtype)
                  for p, s in ((pk, ks), (pv, vs)))
        page_bytes = T * Kh * (2 * D + 2 * 2)
        if layers:
            ragged, plain_r = (K.paged_attention_layers_ragged_q8,
                               ref.paged_attention_layers_ragged_q8_ref)
            decode = None
        else:
            ragged, decode = K.paged_attention_ragged_q8, K.paged_attention_q8
            plain_r, plain_d = (ref.paged_attention_ragged_q8_ref,
                                ref.paged_attention_q8_ref)
    else:
        pk, pv = pk.to(dtype), pv.to(dtype)
        planes = (pk, pv)
        poisoned = (pk.clone(), pv.clone())
        poisoned[0][at], poisoned[1][at] = 1e4, -1e4
        kd, vd = pk, pv
        page_bytes = T * Kh * D * 2 * q.element_size()
        if layers:
            ragged, decode = (K.paged_attention_layers_ragged,
                              K.paged_attention_layers)
            plain_r, plain_d = (ref.paged_attention_layers_ragged_ref,
                                ref.paged_attention_layers_ref)
        else:
            ragged, decode = K.paged_attention_ragged, K.paged_attention
            plain_r, plain_d = (ref.paged_attention_ragged_ref,
                                ref.paged_attention_ref)
    rows = (table, lengths)
    use_decode = qmax == 1 and decode is not None
    if use_decode:
        c.kern = lambda *a: decode(a[0][..., 0, :, :], *a[1:-1])[
            ..., None, :, :]
        c.plain = lambda *a: plain_d(a[0][..., 0, :, :], *a[1:-1])[
            ..., None, :, :]
    else:
        c.kern = lambda *a: ragged(*a)
        c.plain = lambda *a: plain_r(*a)
    # only the multi-layer entries lack a serving caller
    c.entry = (decode if use_decode else ragged) if layers else None
    c.args = (q,) + planes + rows + (q_lens,)
    c.args32 = (q.float(),) + c.args[1:]
    c.poisoned = (q,) + poisoned + rows + (q_lens,)
    if decode is not None:
        c.decode = lambda: decode(q[..., 0, :, :], *planes, *rows)[
            ..., None, :, :]
    else:                        # int8 layers: the single-layer decode
        c.decode = lambda: torch.stack([K.paged_attention_q8(
            q[l][:, 0], *(p[l] for p in planes), *rows)[:, None]
            for l in range(L)])
    if layers:
        single_r = K.paged_attention_ragged_q8 if q8 else \
            K.paged_attention_ragged
        c.layers = L
        c.single = lambda l: (
            single_r(q[l], *(p[l] for p in planes), *rows, q_lens)
            if qmax > 1 or q8 else
            K.paged_attention(q[l][:, 0], *(p[l] for p in planes),
                              *rows)[:, None])

    def dense_kv(*xs):
        """Pool planes gathered through the table, layers folded into the
        batch: (L * B, S, ...)."""
        if not layers:
            return tuple(gather(x, table) for x in xs)
        return tuple(torch.stack([gather(x[l], table) for l in range(L)])
                     .flatten(0, 1) for x in xs)

    def full_kv():
        """The whole function's K/V in PyTorch calls: gather the pages
        (int8: codes and scales, then dequantize the gathered rows)."""
        if not q8:
            return dense_kv(*planes)
        g = dense_kv(*planes)
        return (ref.dequant_pool(g[0], g[2]).to(dtype),
                ref.dequant_pool(g[1], g[3]).to(dtype))
    qf = q.flatten(0, 1) if layers else q
    lens_l, qls_l = lengths.repeat(L), q_lens.repeat(L)
    # SDPA on K/V gathered (and dequantized) beforehand, and the whole
    # function — gather, dequantize, SDPA — in PyTorch calls
    c.library = sdpa(torch, qf, *dense_kv(kd, vd), lens_l, qls_l)
    c.library_gather = lambda: sdpa(torch, qf, *full_kv(), lens_l, qls_l)()
    c.pins = lambda out: paged_pins(torch, c, out)
    c.q_lens, c.out_dtype = q_lens, dtype
    c.rate_dtype = str(dtype).split(".")[-1]
    c.work = paged_work(
        lengths, q_lens, T, page_bytes,
        lambda n, ql: sum(4 * D * (n - ql + i + 1) for i in range(ql)) * H,
        2 * q.numel() * q.element_size() + table.numel() * 4 + 2 * B * 4, L)
    return c


def mla_case(torch, dev, pool_dtype, qmax, seed, layers=None):
    """The MLA entries at phase 2's shapes: one layer, or ``layers`` layers
    through the multi-layer entry."""
    import repro_torch.kernels as K
    from repro_torch.kernels.paged_attention import ops, ref
    B, H, dc, dr, T, MP = (MLA_GEOM[k] for k in "B H dc dr T MP".split())
    P = B * MP + 64
    L = layers or 1
    lead = (L,) if layers else ()
    scale = 1.0 / (128 + 64) ** 0.5            # 1/sqrt(qk_nope + qk_rope)
    g = torch.Generator(dev).manual_seed(seed)
    lengths, q_lens = row_lengths(torch, dev, qmax)
    table = block_table(torch, g, dev, B, MP, P, T, lengths)
    q_c = torch.randn(lead + (B, qmax, H, dc), generator=g, device=dev)
    q_r = torch.randn(lead + (B, qmax, H, dr), generator=g, device=dev)
    pc = torch.randn(lead + (P, T, dc), generator=g, device=dev).to(
        pool_dtype)
    pkr = torch.randn(lead + (P, T, dr), generator=g, device=dev).to(
        pool_dtype)
    dead = dead_slots(torch, P, T, table, lengths)
    at = (slice(None), dead) if layers else (dead,)
    pc2, pkr2 = pc.clone(), pkr.clone()
    pc2[at], pkr2[at] = 1e4, -1e4
    c = Case()
    rows = (table, lengths, q_lens)
    if layers:
        c.entry = K.mla_paged_attention_layers_ragged
        c.kern = lambda *a: K.mla_paged_attention_layers_ragged(*a,
                                                                scale=scale)
        c.plain = lambda *a: ref.mla_paged_attention_layers_ragged_ref(
            *a, scale=scale)
        c.decode = lambda: torch.stack([K.mla_paged_attention(
            q_c[l][:, 0], q_r[l][:, 0], pc[l], pkr[l], *rows[:2],
            scale=scale)[:, None] for l in range(L)])
        c.layers = L
        c.single = lambda l: K.mla_paged_attention_ragged(
            q_c[l], q_r[l], pc[l], pkr[l], *rows, scale=scale)
    elif qmax == 1:
        c.kern = lambda *a: K.mla_paged_attention(
            a[0][:, 0], a[1][:, 0], *a[2:-1], scale=scale)[:, None]
        c.plain = lambda *a: ref.mla_paged_attention_ref(
            a[0][:, 0], a[1][:, 0], *a[2:-1], scale=scale)[:, None]
    else:
        c.kern = lambda *a: K.mla_paged_attention_ragged(*a, scale=scale)
        c.plain = lambda *a: ref.mla_paged_attention_ragged_ref(
            *a, scale=scale)
    if not layers:
        c.decode = lambda: K.mla_paged_attention(
            q_c[:, 0], q_r[:, 0], pc, pkr, table, lengths,
            scale=scale)[:, None]
    c.args = (q_c, q_r, pc, pkr) + rows
    c.args32 = (q_c, q_r, pc.float(), pkr.float()) + rows
    c.poisoned = (q_c, q_r, pc2, pkr2) + rows
    pc3, pkr3 = pc.clone(), pkr.clone()
    pc3[at], pkr3[at] = float("nan"), float("nan")
    # the same rows through the other route (split-KV scratch and a
    # combine, or the in-block fold): a table wide enough that the scratch
    # would pass the cap, or one cut to the live pages; None where no
    # table of these rows flips the route
    route_of = lambda mp: ops.mla_scratch_floats(  # noqa: E731
        L, B, qmax, H, dc, mp) > 0
    live = -(-int(lengths.max()) // T)
    other = None
    if route_of(MP):
        width = MP
        while route_of(width):
            width *= 2
        other = torch.cat([table, table[:, :1].repeat(1, width - MP)], 1)
    elif route_of(live):
        other = table[:, :live].contiguous()

    def pins(out):
        paged_pins(torch, c, out)
        if not torch.equal(c.kern(q_c, q_r, pc3, pkr3, *rows), out):
            raise AssertionError(f"{c.label}: NaN in dead slots changed "
                                 f"the output")
        if other is not None and not torch.equal(
                c.kern(q_c, q_r, pc, pkr, other, *rows[1:]), out):
            raise AssertionError(f"{c.label}: the split route is not the "
                                 f"in-block fold")
    c.pins = pins
    # SDPA: one KV head holding [c, kr], values c, gathered beforehand
    kc = torch.stack([gather(pc.reshape((L, P, T, dc))[l], table)
                      for l in range(L)]).flatten(0, 1).float()
    kr = torch.stack([gather(pkr.reshape((L, P, T, dr))[l], table)
                      for l in range(L)]).flatten(0, 1).float()
    k = torch.cat([kc, kr], dim=-1)[:, :, None]
    q = torch.cat([q_c, q_r], dim=-1).reshape((L * B, qmax, H, dc + dr))
    c.library = sdpa(torch, q, k, kc[:, :, None], lengths.repeat(L),
                     q_lens.repeat(L), scale=scale)
    # a bf16 pool runs on the tensor cores (exact bf16 operands, fp32
    # queries as bf16 terms), so its bound takes the bf16 rate; an fp32
    # pool's products stay on the CUDA cores
    c.q_lens, c.out_dtype = q_lens, torch.float32
    c.rate_dtype = str(pool_dtype).split(".")[-1]
    c.work = paged_work(
        lengths, q_lens, T, T * (dc + dr) * pc.element_size(),
        lambda n, ql: sum((2 * (dc + dr) + 2 * dc) * (n - ql + i + 1)
                          for i in range(ql)) * H,
        (q_c.numel() * 2 + q_r.numel()) * 4 + table.numel() * 4 + 2 * B * 4,
        L)
    scratch = ops.mla_scratch_floats(L, B, qmax, H, dc, MP)
    nbytes, flops = c.work
    c.extra = {"scratch_bytes": 4 * scratch,
               "fold_route": "split" if scratch else "in-block",
               "other_route_pin": other is not None,
               # the bound as PRs 12-14 stated it (fp32 rate), for reading
               # the rows across PRs
               "bound_ms_fp32_rate": 1e3 * max(
                   nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S["float32"])}
    return c


def flash_checks(torch, dev, dtype, seed):
    """The flash kernel against its plain version on the JAX package's test
    cases and the Sq > Skv case (dead rows exactly 0), in ``dtype``; a bf16
    output also against the plain fp32 version. Returns the max error."""
    import repro_torch.kernels as K
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(dev).manual_seed(seed)
    worst = 0.0
    for B, Sq, Skv, H, Kh, D, causal in FLASH_CHECKS:
        q, k, v = (torch.randn(s, generator=g, device=dev).to(dtype)
                   for s in ((B, Sq, H, D), (B, Skv, Kh, D), (B, Skv, Kh, D)))
        out = K.flash_attention(q, k, v, causal=causal)
        ref = flash_attention_ref(q, k, v, causal=causal)
        tol = "bfloat16" if dtype == torch.bfloat16 else "float32"
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[tol][0],
                                   rtol=TOL[tol][1])
        ref32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                    causal=causal)
        a32, r32 = TOL_BF16_VS_FP32 if tol == "bfloat16" else TOL["float32"]
        torch.testing.assert_close(out.float(), ref32, atol=a32, rtol=r32)
        if causal and Sq > Skv and not bool((out[:, :Sq - Skv] == 0).all()):
            raise AssertionError("flash_attention: a row that sees no key "
                                 "is not 0")
        worst = max(worst, float((out.float() - ref.float()).abs().max()))
    log(f"[kernels] flash_attention {str(dtype)[6:]}: {len(FLASH_CHECKS)} JAX-test "
        f"and Sq > Skv cases within tolerance, max abs err {worst:.3e}; "
        f"rows that see no key are 0")
    return worst


def flash_case(torch, dev, dtype, seed, geom=FLASH_GEOM):
    """One layer's attention at ``geom`` (B, Sq, Skv, H, K, D, DV,
    causal): by default InternLM2-1.8B's causal prefill at 4096 tokens.
    The work counts the (query, key) pairs a row sees: all Skv keys
    non-causal, the keys at or before its position causal."""
    import repro_torch.kernels as K
    from repro_torch.kernels.flash_attention.ops import flash_flops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    B, Sq, Skv, H, Kh, D, DV, causal = (
        geom[k] for k in "B Sq Skv H K D DV causal".split())
    scale = 1.0 / D ** 0.5
    g = torch.Generator(dev).manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Skv, Kh, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Skv, Kh, DV), generator=g, device=dev).to(dtype)
    c = Case()
    c.kern = lambda *a: K.flash_attention(*a, causal=causal, scale=scale)
    c.plain = lambda *a: flash_attention_ref(*a, causal=causal, scale=scale)
    c.args, c.args32 = (q, k, v), (q.float(), k.float(), v.float())

    def pins(out):
        if out.shape != (B, Sq, H, DV):
            raise AssertionError(f"flash_attention: output {out.shape}")
        flash_checks(torch, dev, dtype, seed)
    c.pins = pins
    # SDPA's causal mask is aligned top-left: every causal case here has
    # Sq == Skv, where it is the kernel's
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    c.library = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True, scale=scale)
    # fp32 runs on the tensor cores as 3xTF32: its bound takes three TF32
    # products a flop; the bound at the CUDA cores' fp32 rate is kept
    # beside it for reading the rows across PRs
    c.out_dtype = dtype
    c.rate_dtype = "bfloat16" if dtype == torch.bfloat16 else "tf32x3"
    c.work = ((q.numel() + k.numel() + v.numel() + B * Sq * H * DV)
              * q.element_size(), flash_flops(q.shape, k.shape, v.shape,
                                              causal))
    if dtype == torch.float32:
        nbytes, flops = c.work
        c.extra = {"bound_ms_fp32_rate": 1e3 * max(
            nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S["float32"])}
    c.iters = (5, 2, 10)
    return c


def log_records(torch, g, dev, P, T, N):
    """Page and slot indices and int32 valid flags of N log records drawn
    from ``g``: records 128..191 rewrite the targets of records 0..63 (the
    later must win), about one in ten is not valid, and one page and one
    slot index are out of range (clamped)."""
    pg = torch.randint(0, P, (N,), generator=g, device=dev, dtype=torch.int32)
    sl = torch.randint(0, T, (N,), generator=g, device=dev, dtype=torch.int32)
    pg[128:192], sl[128:192] = pg[:64].clone(), sl[:64].clone()
    pg[5], sl[9] = P + 7, -3
    valid = (torch.rand((N,), generator=g, device=dev) < 0.9).to(torch.int32)
    return pg, sl, valid


def log_patch_bytes(pool, pays, n_win, N):
    """The least bytes a patch moves: every page row written once and read
    once, from the pool or, for the ``n_win`` rows that a record wins, from
    its payload; and the page, slot and valid int32 of the N records."""
    C = pool.shape[-1]
    return (2 * pool.numel() * pool.element_size()
            + n_win * C * (pays.element_size() - pool.element_size())
            + 3 * N * 4)


def log_patch_case(torch, dev, dtype, seed):
    """One drain batch of N records (``log_records``) onto a P-page
    pool."""
    import repro_torch.kernels as K
    from repro_torch.kernels.log_patch.ops import route
    from repro_torch.kernels.log_patch.ref import log_patch_ref
    P, T, C, N = (LOG_GEOM[k] for k in "P T C N".split())
    g = torch.Generator(dev).manual_seed(seed)
    pool = torch.randn((P, T, C), generator=g, device=dev).to(dtype)
    pays = torch.randn((N, C), generator=g, device=dev).to(dtype)
    pg, sl, valid = log_records(torch, g, dev, P, T, N)
    c = Case()
    c.exact, c.entry = True, K.log_patch
    c.kern, c.plain = K.log_patch, log_patch_ref
    c.args = (pool, pays, pg, sl, valid)
    # the library call: one index_put over the winning records (targets
    # made unique beforehand: no torch call keeps last-writer-wins)
    page, slot = pg.long().clamp(0, P - 1), sl.long().clamp(0, T - 1)
    last = {}
    for n, (a, b, ok) in enumerate(zip(page.tolist(), slot.tolist(),
                                       valid.tolist())):
        if ok:
            last[(a, b)] = n
    win = torch.tensor(sorted(last.values()), device=dev)
    c.library = lambda: torch.index_put(pool, (page[win], slot[win]),
                                        pays[win])

    def pins(out):
        if not torch.equal(c.library(), out):
            raise AssertionError("log_patch: index_put over the winning "
                                 "records differs")
        wit_pool = torch.zeros((2, 4, 3), device=dev)
        wit_pays = torch.arange(1.0, 4.0, device=dev)[:, None].repeat(1, 3)
        wit = K.log_patch(wit_pool, wit_pays,
                          torch.tensor([5, -1, 0], device=dev),
                          torch.tensor([1, 9, 0], device=dev))
        c.extra["witness_copy_route"] = route(wit_pool, wit_pays, wit)
        if not (wit[1, 1, 0] == 1 and wit[0, 3, 0] == 2 and wit[0, 0, 0] == 3
                and int((wit != 0).sum()) == 9):
            raise AssertionError("log_patch: out-of-range records not "
                                 "clamped as the Pallas kernel clamps")
    c.pins = pins
    c.out_dtype, c.rate_dtype = dtype, str(dtype).split(".")[-1]
    c.work = (log_patch_bytes(pool, pays, len(win), N), 0)
    # the kernel's copy route at these tensors (vector: 16-byte loads and
    # stores), and the (2, 4, 3) fp32 witness's in pins (scalar); not
    # "route", the row's key for cuda or triton
    c.extra = {"copy_route": route(pool, pays, torch.empty_like(pool))}
    return c


def kv_write_case(torch, dev, family, seed):
    """The K/V write at a chat tick (``WRITE_GEOM``, the rows of
    ``tests/kv_write_cases.py``'s ``chat_step``) into one layer's
    ``WRITE_PLANES[family]``, two decode rows' table entries set to -1 and
    to P (dropped). The kernel writes one copy of the planes, the
    boolean-index write (its plain version) another, ``index_put_`` over
    the precomputed targets a third; each copy's planes are views of one
    byte buffer, which the call returns, so the whole pool is compared bit
    for bit. The write is idempotent: timing loops rewrite the same
    bytes."""
    import math
    import repro_torch.kernels as K
    from repro_torch.kernels.paged_attention.ref import kv_page_write_ref
    sys.path.insert(0, str(ROOT / "tests"))
    from kv_write_cases import chat_step, written_slots
    B, Q, T, MP, chunks = (WRITE_GEOM[k] for k in
                           "B Q T MP chunk_rows".split())
    P = B * MP
    table, positions, valid = chat_step(dev, B, Q, T, MP, chunks, seed)
    for b, page in ((chunks + 2, -1), (chunks + 3, P)):
        table[b, int(positions[b, 0]) // T] = page
    g = torch.Generator(dev).manual_seed(seed + 1)
    planes = [(shape, getattr(torch, dt)) for shape, dt in
              WRITE_PLANES[family]]
    sizes = [P * T * math.prod(shape) * dt.itemsize for shape, dt in planes]
    start = torch.randint(0, 256, (sum(sizes),), generator=g, device=dev,
                          dtype=torch.uint8)
    values = [torch.randint(-127, 128, (B, Q) + shape, generator=g,
                            device=dev, dtype=dt) if dt == torch.int8
              else torch.randn((B, Q) + shape, generator=g,
                               device=dev).to(dt) for shape, dt in planes]

    def carve(buf):
        out, at = [], 0
        for (shape, dt), n in zip(planes, sizes):
            out.append(buf[at:at + n].view(dt).view((P, T) + shape))
            at += n
        return out
    bufs = [start.clone() for _ in range(3)]
    kern_pools, plain_pools, lib_pools = (carve(b) for b in bufs)
    logical = (positions // T).clamp(0, MP - 1)
    phys = torch.gather(table, 1, logical).long()
    ok = valid & (phys >= 0) & (phys < P)
    target = (phys[ok], (positions % T)[ok])
    rows = [v[ok] for v in values]
    n_written = int(ok.sum())

    c = Case()
    c.exact, c.args = True, ()
    c.kern = lambda: (K.kv_page_write(kern_pools, values, table, positions,
                                      valid), bufs[0])[1]
    c.plain = lambda: (kv_page_write_ref(plain_pools, values, table,
                                         positions, valid), bufs[1])[1]
    c.library = lambda: [p.index_put_(target, r)
                         for p, r in zip(lib_pools, rows)]

    def pins(out):
        c.library()
        if not torch.equal(bufs[2], out):
            raise AssertionError(f"{c.label}: index_put_ over the targets "
                                 f"differs")
        got = written_slots(carve(start), kern_pools)
        if n_written != int(valid.sum()) - 2 or got != n_written:
            raise AssertionError(f"{c.label}: {got} slots written, "
                                 f"{n_written} to write of "
                                 f"{int(valid.sum())} valid")
    c.pins = pins
    c.rate_dtype = "bfloat16"
    # each written slot reads and writes its rows once and reads a table
    # entry; every slot reads its flag and its int64 position
    row_bytes = sum(math.prod(shape) * dt.itemsize for shape, dt in planes)
    c.work = (n_written * (2 * row_bytes + 4) + B * Q * (1 + 8), 0)
    c.iters = (100, 20, 20)
    c.extra = {"written_slots": n_written, "planes": len(planes)}
    return c


def measure(torch, name, c, what):
    """Hold a case against its plain version and pins; time it; for an
    entry no serving path calls, its public-entry run. Returns the row
    fields of this case."""
    import repro_torch.kernels as K
    out, ref = c.kern(*c.args), c.plain(*c.args)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    fields = {"max_abs_err": err}
    if c.exact:
        if not torch.equal(out, ref):
            raise AssertionError(f"{name} {what}: not bit for bit the plain "
                                 f"version")
        check = "bit for bit"
    else:
        tol = "bfloat16" if c.out_dtype == torch.bfloat16 else "float32"
        atol, rtol = TOL[tol]
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)
        # the plain fp32 version on the same values: a bf16 output within
        # half an ulp, an fp32 output (MLA over a bf16 pool) within fp32
        # tolerance
        ref32 = c.plain(*c.args32).float()
        a32, r32 = TOL_BF16_VS_FP32 if tol == "bfloat16" else TOL["float32"]
        torch.testing.assert_close(out.float(), ref32, atol=a32, rtol=r32)
        fields["max_abs_err_vs_fp32"] = float((out.float() - ref32).abs()
                                              .max())
        check = (f"atol {atol}; vs plain fp32 "
                 f"{fields['max_abs_err_vs_fp32']:.3e} (atol {a32}, rtol "
                 f"{r32})")
    del ref
    c.label = f"{name} {what}"
    c.pins(out)
    nbytes, flops = c.work
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FLOPS_PER_S[c.rate_dtype]
    bound = max(t_bytes, t_ops)
    ki, pi, li = c.iters
    # host-paced times (ms, plain_ms, library_ms, library_gather_ms) and
    # card-only times (card_ms, library_card_ms, library_gather_card_ms)
    kern = lambda: c.kern(*c.args)                      # noqa: E731
    ms = cuda_ms(torch, kern, ki)
    fields["card_ms"] = cuda_ms(torch, kern, ki, card_only=True)
    plain_ms = cuda_ms(torch, lambda: c.plain(*c.args), pi)
    lib_ms = cuda_ms(torch, c.library, li)
    fields["library_card_ms"] = cuda_ms(torch, c.library, li, card_only=True)
    lib_note = ""
    if c.library_gather is not None:
        fields["library_gather_ms"] = cuda_ms(torch, c.library_gather, li)
        fields["library_gather_card_ms"] = cuda_ms(
            torch, c.library_gather, li, card_only=True)
        lib_note = (f" (gather + SDPA {fields['library_gather_ms']:.4f} ms, "
                    f"card {fields['library_gather_card_ms']:.4f} ms)")
    log(f"[kernels] {name} {what}: max_abs_err {err:.3e} ({check}); kernel "
        f"{ms:.4f} ms (card {fields['card_ms']:.4f} ms), plain "
        f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms (card "
        f"{fields['library_card_ms']:.4f} ms){lib_note}, "
        f"bound {bound * 1e3:.4f} ms ({nbytes} B = {t_bytes * 1e3:.4f} ms, "
        f"{flops} flop = {t_ops * 1e3:.4f} ms at {c.rate_dtype}); "
        f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
        f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s"
        + "".join(f", {k} {v}" for k, v in c.extra.items()))
    fields.update(c.extra)
    fields.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": lib_ms})
    if c.entry is not None:
        # the public-entry run: no serving path calls this entry
        K.reset_launch_counts()
        again = c.kern(*c.args)
        torch.cuda.synchronize()
        launches = c.entry.launches
        others = {e.__name__: e.launches for e in K.COUNTED
                  if e is not c.entry and e.launches}
        if launches != 1 or others or not torch.equal(again, out):
            raise AssertionError(f"{name} {what}: public-entry run launched "
                                 f"{launches} (others {others})")
        fields.update({"launches": launches, "path": "public entry"})
    return fields


def phase_kernels(torch, dev, seed):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # row → [(what, case builder)]; the first case is the row's headline
    # (the dtype its serve phase runs), the rest are kept under their names
    bf16, f32 = torch.bfloat16, torch.float32
    plan = {
        "paged_attention_ragged": [
            (f"{d} Qmax={CHUNK}", lambda d=d: dense_case(torch, dev, d, CHUNK,
                                                         seed))
            for d in (bf16, f32)],
        "paged_attention": [
            (f"{d} Qmax=1", lambda d=d: dense_case(torch, dev, d, 1, seed))
            for d in (bf16, f32)],
    }
    # the configs' head shapes through the ragged entry (a chunk tick) and
    # the decode entry (Qmax 1)
    for arch, (H, Kh, D) in CONFIG_GEOMS.items():
        geom = dict(GEOM, H=H, K=Kh, D=D)
        for name, qm in (("paged_attention_ragged", CHUNK),
                         ("paged_attention", 1)):
            plan[name] += [
                (f"{d} Qmax={qm} {arch} H={H} K={Kh} D={D}",
                 lambda d=d, qm=qm, geom=geom: dense_case(
                     torch, dev, d, qm, seed, geom=geom))
                for d in (bf16, f32)]
    plan.update({
        "paged_attention_layers": [
            (f"{d} L={LAYERS} Qmax=1", lambda d=d: dense_case(
                torch, dev, d, 1, seed, layers=LAYERS))
            for d in (bf16, f32)],
        "paged_attention_layers_ragged": [
            (f"{d} L={LAYERS} Qmax={CHUNK}", lambda d=d: dense_case(
                torch, dev, d, CHUNK, seed, layers=LAYERS))
            for d in (bf16, f32)],
        "paged_attention_ragged_q8": [
            (f"q {d} Qmax={qm}", lambda d=d, qm=qm: dense_case(
                torch, dev, d, qm, seed, q8=True))
            for qm in (CHUNK, 1) for d in (bf16, f32)],
        "paged_attention_layers_ragged_q8": [
            (f"q {d} L={LAYERS} Qmax={qm}", lambda d=d, qm=qm: dense_case(
                torch, dev, d, qm, seed, q8=True, layers=LAYERS))
            for qm in (CHUNK, 1) for d in (bf16, f32)],
        "mla_paged_attention_ragged": [
            (f"pool {d} Qmax={qm}", lambda d=d, qm=qm: mla_case(
                torch, dev, d, qm, seed))
            for qm in (CHUNK, 1) for d in (bf16, f32)],
        "mla_paged_attention_layers_ragged": [
            (f"pool {d} L={MLA_LAYERS} Qmax={qm}", lambda d=d, qm=qm: mla_case(
                torch, dev, d, qm, seed, layers=MLA_LAYERS))
            for qm in (CHUNK, 1) for d in (bf16, f32)],
        "flash_attention": [
            (f"{d} S={FLASH_GEOM['Sq']} causal", lambda d=d: flash_case(
                torch, dev, d, seed)) for d in (bf16, f32)] + [
            (f"{d} B={TRAIN_FLASH['B']} S={TRAIN_FLASH['Sq']} causal train",
             lambda d=d: flash_case(torch, dev, d, seed, geom=TRAIN_FLASH))
            for d in (bf16, f32)] + [
            (f"{d} S={S} causal zamba2-1.2b H={H} K={Kh} D={D}",
             lambda d=d, g=dict(B=1, Sq=S, Skv=S, H=H, K=Kh, D=D, DV=D,
                                causal=True): flash_case(
                 torch, dev, d, seed, geom=g))
            for H, Kh, D in (ZAMBA2_FLASH,) for S in ZAMBA2_FLASH_S
            for d in (bf16, f32)] + [
            (f"{d} Sq={Sq} Skv={Skv} {'causal' if causal else 'non-causal'}"
             f" {what} H={H} K={Kh} D={D} DV={DV}",
             lambda d=d, g=dict(B=1, Sq=Sq, Skv=Skv, H=H, K=Kh, D=D, DV=DV,
                                causal=causal): flash_case(
                 torch, dev, d, seed, geom=g))
            for what, Sq, Skv, H, Kh, D, DV, causal in FLASH_SHAPES
            for d in (bf16, f32)],
        "log_patch": [
            (f"{d} P={LOG_GEOM['P']} N={LOG_GEOM['N']}",
             lambda d=d: log_patch_case(torch, dev, d, seed))
            for d in (bf16, f32)],
        "kv_page_write": [
            (f"{fam} B={WRITE_GEOM['B']} Qmax={WRITE_GEOM['Q']} "
             f"P={WRITE_GEOM['B'] * WRITE_GEOM['MP']}",
             lambda fam=fam: kv_write_case(torch, dev, fam, seed))
            for fam in WRITE_PLANES],
    })
    rows = {}
    for name, cases in plan.items():
        row = {"name": name, "route": "cuda", "source": ROWS[name][1],
               "replaces": ROWS[name][0], "cases": {}}
        for i, (what, build) in enumerate(cases):
            what = what.replace("torch.", "")
            fields = measure(torch, name, build(), what)
            free(torch)
            if i == 0:
                row.update(fields)
            row["cases"][what] = fields
        rows[name] = row
    return rows


# ------------------------------------------------------------ phases 3-9
def make_model(torch, cfg, dtype, dev, seed, kv_cache_dtype="native"):
    from repro_torch.models import LM
    return LM(cfg, dtype=dtype, device=dev,
              kv_cache_dtype=kv_cache_dtype).init(
        torch.Generator(dev).manual_seed(seed))


def requests(n, lo, hi, max_new, vocab, seed):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        0, vocab, int(rng.integers(lo, hi + 1)), dtype=np.int32),
        max_new=max_new) for i in range(n)]


def requests_of(lens, max_new, vocab, seed):
    """Requests with prompts of the given lengths (tokens from ``seed``)."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, n, dtype=np.int32),
                    max_new=max_new) for i, n in enumerate(lens)]


def engine(model, dev, *, hbm, fuse=True, max_len=560, chunk=CHUNK,
           prefix_tokens=0, async_tiering=False, kv_engine="paged",
           **features):
    """The serve phases' engine; ``features`` go to ``ServeConfig``
    (``speculate_k``, ``draft_proposer``, ``journal``, ``fault_plan``,
    ``paged_decode``)."""
    from repro_torch.core.engines import EngineSpec
    from repro_torch.serving import ServeConfig, ServingEngine
    return ServingEngine(model, ServeConfig(
        max_len=max_len, page_tokens=16, max_batch_seqs=8,
        prefill_chunk_tokens=chunk, fuse_ticks=fuse,
        engine_spec=EngineSpec(engine=kv_engine, kv_hbm_bytes=hbm,
                               prefix_cache_tokens=prefix_tokens,
                               async_tiering=async_tiering), **features),
        device=dev)


def launch_counts(ops):
    """Every counted entry's launches since the counts were last set to 0
    (``ops.COUNTED``: the K/V write too), checked at one K/V write a
    launch of a single-layer paged entry."""
    counts = {e.__name__: e.launches for e in ops.COUNTED}
    attends = sum(counts.get(k, 0) for k in STEP_ENTRIES)
    if counts.get(WRITE, 0) != attends:
        raise AssertionError(f"{counts.get(WRITE, 0)} {WRITE} launches for "
                             f"{attends} paged attention launches")
    return counts


def launched_besides(counts, *names):
    """The entries other than ``names`` and the K/V write (which
    ``launch_counts`` checks) that launched."""
    return {k: n for k, n in counts.items()
            if n and k not in names and k != WRITE}


def free(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def serve(torch, dev, seed, what, model, entry):
    """Phase 3's workload through ``model`` on a 1 GiB pool, with the
    launch counts set to 0 just before and read just after; checks and
    returns (launches of ``entry``, pool pages, every entry's launches)."""
    import repro_torch.kernels as ops
    cfg = model.cfg
    reqs = requests(8, 64, 512, 32, cfg.vocab_size, seed)
    eng = engine(model, dev, hbm=1 << 30)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(ops)
    launches = counts[entry.__name__]
    others = launched_besides(counts, entry.__name__)
    s = eng.stats()
    new = sum(len(r.generated) for r in reqs)
    if not all(r.done and len(r.generated) == 32 for r in reqs):
        raise AssertionError(f"{what}: a request did not finish")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated):
        raise AssertionError(f"{what}: a token is out of the vocab")
    if s["mirror_d2h_bytes"] != 0:
        raise AssertionError(f"{what}: mirror bytes {s['mirror_d2h_bytes']}")
    if s["step_calls"] != s["sched_ticks"]:
        raise AssertionError(f"{what}: step_calls != ticks")
    if launches <= 0 or launches != cfg.num_layers * s["step_calls"] \
            or counts[WRITE] != launches or others:
        raise AssertionError(f"{what}: {launches} {entry.__name__} launches "
                             f"and {counts[WRITE]} {WRITE} launches for "
                             f"{s['step_calls']} steps; others {others}")
    pages = eng.tiered.pool_pages
    log(f"[{what}] {cfg.name} {cfg.num_layers} layers, {model.dtype}, "
        f"{eng.desc.family} pool: {len(reqs)} requests, prompts "
        f"{[len(r.prompt) for r in reqs]}, {new} new tokens in {wall:.3f} s "
        f"= {new / wall:.2f} tok/s (incl. prefill); ticks {s['sched_ticks']}, "
        f"step_calls {s['step_calls']}, {entry.__name__} launches "
        f"{launches}, {WRITE} launches {counts[WRITE]}, mirror_d2h_bytes {s['mirror_d2h_bytes']}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, pool pages "
        f"{pages} of {eng.desc.page_group_bytes} B")
    return launches, pages, counts


def prompt_state(torch, model, prompt, first, max_len):
    """(logits, dense cache) after ``prompt`` along the sequential
    reference: its first ``first`` tokens (all when None) prefilled at
    once, the rest through the dense decode step one by one."""
    first = len(prompt) if first is None else min(first, len(prompt))
    logits, cache = model.prefill(
        torch.as_tensor(prompt[None, :first], device=model.device), max_len)
    for t in prompt[first:]:
        logits, cache = decode(torch, model, cache, int(t))
    return logits, cache


def decode(torch, model, cache, token):
    return model.decode_step(
        cache, torch.tensor([[token]], device=model.device), cache["pos"])


def chunked_sequential(torch, model, reqs, first, max_len=560):
    """The sequential reference with the pooled path's prompt split: the
    first chunk prefilled, later prompt tokens through the decode step.
    An int8 cache needs it: a chunked prompt's later tokens attend over
    the QUANTIZED K/V of earlier chunks, where one-shot prefill attends
    over unquantized K/V — another function, not noise."""
    for req in reqs:
        logits, cache = prompt_state(torch, model, req.prompt, first, max_len)
        for _ in range(req.max_new):
            nxt = int(torch.argmax(logits[:, -1], -1)[0])
            req.generated.append(nxt)
            logits, cache = decode(torch, model, cache, nxt)
        req.done = True
    return reqs


def reference_margin(torch, model, req, step, first, max_len):
    """The sequential reference's own top-2 logit margin and logit std at
    ``step``, replayed over its tokens."""
    logits, cache = prompt_state(torch, model, req.prompt, first, max_len)
    for t in req.generated[:step]:
        logits, cache = decode(torch, model, cache, t)
    lv = logits[0, -1, :model.cfg.vocab_size].double()
    top = torch.topk(lv, 2).values
    return float(top[0] - top[1]), float(lv.std())


def check_identical(torch, model, got, ref, what, first=None, max_len=560):
    """Token identity, where a divergence is accepted only at a reference
    near-tie (top-2 margin below 1e-4 of the logit std)."""
    for r, rr in zip(got, ref):
        if r.generated == rr.generated:
            continue
        step = next(i for i, (a, b) in enumerate(zip(r.generated,
                                                     rr.generated)) if a != b)
        margin, std = reference_margin(torch, model, rr, step, first, max_len)
        log(f"[{what}] request {r.rid} differs at step {step}: reference "
            f"top-2 margin {margin:.3e}, logit std {std:.3e}")
        if margin >= 1e-4 * std:
            raise AssertionError(f"{what}: request {r.rid} diverged at step "
                                 f"{step} with a clear margin")


def serve_long(torch, dev, seed, model, what="serve-long",
               entry="paged_attention_ragged"):
    """Phases 14 and 24: whole-prompt prefill of ``LONG_PROMPTS`` (no
    prefill chunks) through the flash-attention kernel, then pooled, fused
    decode through the family's ragged ``entry``, on a 2 GiB pool, with
    the launch counts set to 0 just before and read just after. Returns
    every entry's launches."""
    import repro_torch.kernels as K
    cfg = model.cfg
    reqs = requests_of(LONG_PROMPTS, 32, cfg.vocab_size, seed)
    max_len = -(-(max(LONG_PROMPTS) + 32 + 1) // 16) * 16   # whole pages
    eng = engine(model, dev, hbm=2 << 30, max_len=max_len, chunk=None)
    prefill_ms = {}
    admit = eng.prefill_one

    def timed_prefill(req, *a, **kw):      # host clock around synced work
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = admit(req, *a, **kw)
        torch.cuda.synchronize()
        prefill_ms[req.rid] = (time.perf_counter() - t) * 1e3
        return out
    eng.prefill_one = timed_prefill
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(K)
    s = eng.stats()
    flash, paged = counts["flash_attention"], counts[entry]
    others = launched_besides(counts, "flash_attention", entry)
    n_long = sum(n > model.chunk_size for n in LONG_PROMPTS)
    if not all(r.done and len(r.generated) == 32 for r in reqs) or not all(
            0 <= t < cfg.vocab_size for r in reqs for t in r.generated):
        raise AssertionError(f"{what}: a request did not finish in vocab")
    if s["mirror_d2h_bytes"] != 0 or s["sched_prefill_chunks"] != 0:
        raise AssertionError(f"{what}: mirror bytes "
                             f"{s['mirror_d2h_bytes']}, prefill chunks "
                             f"{s['sched_prefill_chunks']}")
    if flash != cfg.num_layers * n_long or sorted(prefill_ms) != list(
            range(len(reqs))):
        raise AssertionError(f"{what}: {flash} flash launches for "
                             f"{n_long} long prompts; prefills {prefill_ms}")
    if s["step_calls"] != s["sched_ticks"] or others \
            or paged != cfg.num_layers * s["step_calls"]:
        raise AssertionError(f"{what}: {paged} {entry} launches for "
                             f"{s['step_calls']} steps; others {others}")
    new = sum(len(r.generated) for r in reqs)
    log(f"[{what}] {cfg.name} {cfg.num_layers} layers, {model.dtype}, "
        f"whole-prompt prefill of prompts {list(LONG_PROMPTS)}: {new} new "
        f"tokens in {wall:.3f} s = {new / wall:.2f} tok/s (incl. prefill); "
        f"prefill ms per request "
        f"{ {r.rid: round(prefill_ms[r.rid], 3) for r in reqs} }; ticks "
        f"{s['sched_ticks']}, flash_attention launches {flash} (= "
        f"{cfg.num_layers} x {n_long}), {entry} launches "
        f"{paged} (= {cfg.num_layers} x {s['step_calls']}), mirror_d2h_bytes "
        f"{s['mirror_d2h_bytes']}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, pool pages "
        f"{eng.tiered.pool_pages}")
    return counts


def parity_long(torch, dev, seed, cfg, what="parity-long",
                entry="paged_attention_ragged"):
    """Phases 15 and 25: fp32 at ``cfg``'s width, whole-prompt prefill of
    1100- and 2048-token prompts: ``generate()`` against
    ``generate_sequential()`` (both prefill through the flash kernel),
    token-identical apart from reference near-ties; then ``LM.prefill`` of
    the 2048-token prompt through the flash kernel against the same
    model's plain ``full_attention`` branch (``chunk_size`` past the
    prompt): last logits and every layer's cache planes (K/V; MLA's
    latent ``c`` and rope key ``kr``) within fp32 tolerance. Returns every
    entry's launches in the ``generate()`` run."""
    import repro_torch.kernels as K
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = make_model(torch, cfg, torch.float32, dev, seed)
    lens, max_len = (1100, 2048), 2048 + 16
    ref = engine(model, dev, hbm=4 << 30, max_len=max_len, chunk=None
                 ).generate_sequential(
        requests_of(lens, 8, cfg.vocab_size, seed + 3))
    got = requests_of(lens, 8, cfg.vocab_size, seed + 3)
    K.reset_launch_counts()
    eng = engine(model, dev, hbm=4 << 30, max_len=max_len, chunk=None)
    eng.generate(got)
    torch.cuda.synchronize()
    counts = launch_counts(K)
    flash = counts["flash_attention"]
    others = launched_besides(counts, "flash_attention", entry)
    if flash != cfg.num_layers * len(lens) or others:
        raise AssertionError(f"{what}: {flash} flash launches; others "
                             f"{others}")
    check_identical(torch, model, got, ref, what, max_len=max_len)
    log(f"[{what}] {cfg.name} {cfg.num_layers} layers fp32: generate() "
        f"== generate_sequential() on prompts {list(lens)} x 8 tokens "
        f"(flash launches {flash}, ticks {eng.stats()['sched_ticks']})")
    del eng
    free(torch)
    tokens = torch.as_tensor(got[-1].prompt[None], device=dev)
    chunk = model.chunk_size
    K.reset_launch_counts()
    logits, cache = model.prefill(tokens, max_len)
    flash = K.flash_attention.launches
    model.chunk_size = tokens.shape[1]       # the plain full_attention
    try:
        plain_logits, plain_cache = model.prefill(tokens, max_len)
    finally:
        model.chunk_size = chunk
    torch.cuda.synchronize()
    if flash != cfg.num_layers or K.flash_attention.launches != flash:
        raise AssertionError(f"{what}: flash launches {flash}, then "
                             f"{K.flash_attention.launches - flash} more")
    errs = compare_planes(torch, what, "prefill", (logits, cache),
                          (plain_logits, plain_cache), model.plane_names)
    log(f"[{what}] {tokens.shape[1]}-token LM.prefill through the flash "
        f"kernel ({flash} launches) == the full_attention branch within fp32 "
        f"tolerance: {errs}")
    del model, cache, plain_cache
    free(torch)
    return counts


def compare_planes(torch, what, step, got, want, planes):
    """The last logits and each named cache plane of ``got`` against
    ``want`` (``(logits, cache)`` pairs) at fp32 tolerance, flash against
    the plain branch; returns the max abs errors by name."""
    atol, rtol = TOL["float32"]
    errs = {}
    for name in ("logits",) + tuple(planes):
        a, b = ((got[0], want[0]) if name == "logits"
                else (got[1][name], want[1][name]))
        errs[name] = float((a - b).abs().max())
        log(f"[{what}] {step} {name} {tuple(a.shape)}: flash vs "
            f"full_attention max abs err {errs[name]:.3e} (atol {atol}, "
            f"rtol {rtol})")
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol)
    return errs


def reference(torch, model, dev, reqs, first):
    """``generate_sequential()``, or with ``first`` set the chunk-aware
    :func:`chunked_sequential`."""
    if first is None:
        return engine(model, dev, hbm=1 << 30).generate_sequential(reqs)
    return chunked_sequential(torch, model, reqs, first)


def parity(torch, dev, seed, what, cfg, *, kv_cache_dtype="native",
           full_width_check=True, first=None):
    """fp32: ``generate()`` against the sequential reference on ``cfg``
    (when ``full_width_check``), then 4 layers of it on a pool tight
    enough to preempt. ``first`` selects the chunk-aware reference.
    Returns the 4-layer model and its reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if full_width_check:
        model = make_model(torch, cfg, torch.float32, dev, seed,
                           kv_cache_dtype)
        ref = reference(torch, model, dev,
                        requests(4, 64, 400, 16, cfg.vocab_size, seed + 1),
                        first)
        got = requests(4, 64, 400, 16, cfg.vocab_size, seed + 1)
        eng = engine(model, dev, hbm=4 << 30)
        eng.generate(got)
        check_identical(torch, model, got, ref, what, first)
        log(f"[{what}] {cfg.name} {cfg.num_layers} layers fp32 "
            f"{eng.desc.family} pool: generate() == "
            f"{'generate_sequential()' if first is None else 'the chunk-aware sequential reference'}"
            f" on {len(got)} requests x 16 tokens (ticks "
            f"{eng.stats()['sched_ticks']})")
        if first is not None:
            one_shot = engine(model, dev, hbm=4 << 30).generate_sequential(
                requests(4, 64, 400, 16, cfg.vocab_size, seed + 1))
            same = [a.generated == b.generated for a, b in zip(got, one_shot)]
            log(f"[{what}] against the one-shot generate_sequential(): "
                f"{sum(same)}/{len(same)} requests identical {same}")
        del model, eng
        free(torch)
    cfg4 = dataclasses.replace(cfg, num_layers=4)
    model4 = make_model(torch, cfg4, torch.float32, dev, seed, kv_cache_dtype)
    ref4 = reference(torch, model4, dev,
                     requests(4, 64, 400, 16, cfg.vocab_size, seed + 2),
                     first)
    tight = requests(4, 64, 400, 16, cfg.vocab_size, seed + 2)
    eng = engine(model4, dev,
                 hbm=40 * model4.cache_descriptor(16).page_group_bytes)
    eng.generate(tight)
    s = eng.stats()
    if s["preempts"] <= 0:
        raise AssertionError(f"{what}: the tight pool did not preempt")
    check_identical(torch, model4, tight, ref4, what + "-tight", first)
    log(f"[{what}] 4-layer fp32 tight {eng.desc.family} pool "
        f"({eng.tiered.pool_pages} pages): token-identical with "
        f"{s['preempts']} preempts, {s['pool_page_spills']} page spills")
    return model4, ref4


def unfused(torch, dev, seed, what, model4, ref4, entry, ragged,
            first=None):
    """The 4-layer run with ``fuse_ticks=False``: prompt chunks go token
    by token through ``entry`` (a decode entry); the first chunk's tick
    runs the family's ``ragged`` entry, and no other entry may launch.
    Returns every entry's launches."""
    import repro_torch.kernels as ops
    got = requests(4, 64, 400, 16, model4.cfg.vocab_size, seed + 2)
    eng = engine(model4, dev, hbm=1 << 30, fuse=False)
    ops.reset_launch_counts()
    eng.generate(got)
    torch.cuda.synchronize()
    counts = launch_counts(ops)
    launches = counts[entry.__name__]
    others = launched_besides(counts, entry.__name__, ragged.__name__)
    if launches <= 0 or others:
        raise AssertionError(f"{what}: {launches} {entry.__name__} launches;"
                             f" others {others}")
    check_identical(torch, model4, got, ref4, what, first)
    log(f"[{what}] 4-layer fp32 fuse_ticks=False: token-identical, "
        f"{entry.__name__} launches {launches}, all: {counts}")
    return counts


# ---------------------------------------------------------- phases 10-13
class ReferenceDrafts:
    """Draft proposer of the parity phases: the sequential reference's own
    greedy continuation, every draft from the ``wrong_at``-th on
    corrupted, so each decode tick accepts some drafts and rolls the rest
    back. Whether a draft is accepted is still decided by the pooled
    run's own argmax."""

    def __init__(self, ref, wrong_at, vocab):
        self.full = {r.rid: [int(t) for t in r.prompt] + list(r.generated)
                     for r in ref}
        self.wrong_at, self.vocab = wrong_at, vocab

    def propose(self, seq, tokens, k):
        full, n = self.full[seq], len(tokens)
        return [(full[n + j] + (j >= self.wrong_at)) % self.vocab
                for j in range(min(k, len(full) - n))]

    def drop(self, seq):
        pass


def qmax_launches(entry, qmax):
    return entry.launches_by_qmax.get(qmax, 0)


def serve_spec(torch, dev, seed, model):
    """Phase 10: phase 3's workload with ``speculate_k = SPEC_K`` drafts
    from the n-gram proposer, with the launch counts set to 0 just before
    and read just after. Returns (every entry's launches, #1's launches
    at Qmax 8)."""
    import repro_torch.kernels as ops
    cfg = model.cfg
    reqs = requests(8, 64, 512, 32, cfg.vocab_size, seed)
    eng = engine(model, dev, hbm=1 << 30, speculate_k=SPEC_K)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(ops)
    entry = ops.paged_attention_ragged
    q8 = qmax_launches(entry, 8)
    others = launched_besides(counts, entry.__name__)
    s = eng.stats()
    if not all(r.done and len(r.generated) == 32 for r in reqs) or not all(
            0 <= t < cfg.vocab_size for r in reqs for t in r.generated):
        raise AssertionError("serve-spec: a request did not finish in vocab")
    if s["mirror_d2h_bytes"] != 0 or s["step_calls"] != s["sched_ticks"]:
        raise AssertionError(f"serve-spec: mirror bytes "
                             f"{s['mirror_d2h_bytes']}, step_calls "
                             f"{s['step_calls']} for {s['sched_ticks']} ticks")
    if entry.launches != cfg.num_layers * s["step_calls"] or others \
            or s["spec_proposed"] <= 0 or q8 <= 0:
        raise AssertionError(f"serve-spec: {entry.launches} launches ({q8} "
                             f"at Qmax 8) for {s['step_calls']} steps, "
                             f"{s['spec_proposed']} drafts; others {others}")
    new = sum(len(r.generated) for r in reqs)
    log(f"[serve-spec] {cfg.name} {cfg.num_layers} layers, {model.dtype}, "
        f"speculate_k {SPEC_K} (n-gram drafts): {new} new tokens in "
        f"{wall:.3f} s = {new / wall:.2f} tok/s (incl. prefill); ticks "
        f"{s['sched_ticks']}, decode row-steps {s['sched_decode_rows']}, "
        f"spec_proposed {s['spec_proposed']}, spec_accepted "
        f"{s['spec_accepted']}, rejected "
        f"{s['spec_proposed'] - s['spec_accepted']}; {entry.__name__} "
        f"launches {entry.launches} by Qmax {entry.launches_by_qmax}, "
        f"mirror_d2h_bytes {s['mirror_d2h_bytes']}")
    return counts, q8


def parity_spec(torch, dev, seed, what, cfg, entry, *,
                kv_cache_dtype="native", first=None):
    """Phase 11, one family: 4 layers at full width in fp32, speculative
    ``generate()`` (``ReferenceDrafts``) against the sequential reference
    (``first`` selects the chunk-aware one); needs accepted AND rejected
    drafts and ``entry`` launched at Qmax 8. Returns (every entry's
    launches, ``entry``'s launches at Qmax 8)."""
    import repro_torch.kernels as ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg4 = dataclasses.replace(cfg, num_layers=4)
    model4 = make_model(torch, cfg4, torch.float32, dev, seed, kv_cache_dtype)
    ref = reference(torch, model4, dev,
                    requests(4, 64, 400, 16, cfg.vocab_size, seed + 2), first)
    got = requests(4, 64, 400, 16, cfg.vocab_size, seed + 2)
    eng = engine(model4, dev, hbm=1 << 30, speculate_k=SPEC_K,
                 draft_proposer=ReferenceDrafts(ref, 2, cfg.vocab_size))
    ops.reset_launch_counts()
    eng.generate(got)
    torch.cuda.synchronize()
    counts = launch_counts(ops)
    q8 = qmax_launches(entry, 8)
    others = launched_besides(counts, entry.__name__)
    s = eng.stats()
    if not 0 < s["spec_accepted"] < s["spec_proposed"] or q8 <= 0 \
            or entry.launches != 4 * s["step_calls"] or others:
        raise AssertionError(
            f"{what}: spec_accepted {s['spec_accepted']} of "
            f"{s['spec_proposed']}, {entry.launches} launches ({q8} at Qmax "
            f"8) for {s['step_calls']} steps; others {others}")
    check_identical(torch, model4, got, ref, what, first)
    ref_name = ("generate_sequential()" if first is None
                else "the chunk-aware sequential reference")
    log(f"[{what}] 4-layer fp32 {eng.desc.family} pool, speculate_k "
        f"{SPEC_K}: generate() == {ref_name}"
        f" on {len(got)} requests x 16 tokens; spec_proposed "
        f"{s['spec_proposed']}, spec_accepted {s['spec_accepted']}, ticks "
        f"{s['sched_ticks']}, {entry.__name__} launches {entry.launches} by "
        f"Qmax {entry.launches_by_qmax}")
    del model4, eng
    free(torch)
    return counts, q8


def prefix_requests(n, max_new, vocab, seed, tails=(32, 256)):
    """``n`` requests that share a ``PREFIX_TOKENS``-token head, each with
    its own tail of ``tails[0]``–``tails[1]`` tokens."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, PREFIX_TOKENS, dtype=np.int32)
    return [Request(rid=i, prompt=np.concatenate([head, rng.integers(
        0, vocab, int(rng.integers(tails[0], tails[1] + 1)),
        dtype=np.int32)]), max_new=max_new) for i in range(n)]


def serve_prefix(torch, dev, seed, model):
    """Phase 12, full width: the first request publishes the shared head,
    the other 7 splice it from the prefix cache; then the same requests
    through an engine without the cache. Each run with the launch counts
    set to 0 just before and read just after. Returns every entry's
    launches over both runs."""
    import repro_torch.kernels as ops
    cfg = model.cfg
    served = collections.Counter()
    walls = {}
    for cache in (4096, 0):
        reqs = prefix_requests(8, 32, cfg.vocab_size, seed + 5)
        eng = engine(model, dev, hbm=1 << 30, max_len=PREFIX_MAX_LEN,
                     prefix_tokens=cache)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        eng.generate(reqs[:1])
        eng.generate(reqs[1:])
        torch.cuda.synchronize()
        walls[cache] = time.perf_counter() - t0
        counts = launch_counts(ops)
        served.update(counts)
        s = eng.stats()
        launches = counts["paged_attention_ragged"]
        others = launched_besides(counts, "paged_attention_ragged")
        hits = 7 if cache else 0
        if s["prefix_hits"] != hits \
                or s["prefix_tokens_reused"] != hits * PREFIX_TOKENS \
                or s["prefill_calls"] != (1 if cache else 8) \
                or s["mirror_d2h_bytes"] != 0 or others \
                or launches != cfg.num_layers * s["step_calls"] \
                or not all(r.done and len(r.generated) == 32 for r in reqs):
            raise AssertionError(
                f"serve-prefix (cache {cache}): hits {s['prefix_hits']}, "
                f"reused {s['prefix_tokens_reused']}, prefill_calls "
                f"{s['prefill_calls']}, {launches} launches for "
                f"{s['step_calls']} steps, others {others}")
        new = sum(len(r.generated) for r in reqs)
        log(f"[serve-prefix] {cfg.name} {cfg.num_layers} layers, "
            f"{model.dtype}, prefix_cache_tokens {cache}: prompts "
            f"{[len(r.prompt) for r in reqs]} ({PREFIX_TOKENS}-token shared "
            f"head), {new} new tokens in {walls[cache]:.3f} s = "
            f"{new / walls[cache]:.2f} tok/s (incl. prefill); prefix_hits "
            f"{s['prefix_hits']}, prefix_tokens_reused "
            f"{s['prefix_tokens_reused']}, prefill_calls "
            f"{s['prefill_calls']}, sched_prefill_chunks "
            f"{s['sched_prefill_chunks']}, ticks {s['sched_ticks']}, "
            f"paged_attention_ragged launches {launches}")
        del eng
    log(f"[serve-prefix] wall with the cache / without: "
        f"{walls[4096]:.3f} / {walls[0]:.3f} s")
    return served


# the 4-layer prefix parity run: 16-token pages, a pool of 44 pages
# (max_pages 43 + 1), 128-token chunks; requests 0, 1, 3 and 5 are one
# 424-token prompt (the head and a 40-token tail: a splice covers 423
# tokens, so its boundary page is shared mid-page), 2 and 4 other tails
PREFIX_PARITY = dict(pages=44, dups=(0, 1, 3, 5), dup_tail=40,
                     tails=(40, 200))


def prefix_parity(torch, dev, seed, cfg):
    """Phase 12, parity: 4 layers at full width in fp32 on a pool tight
    enough to preempt. Request 0 publishes the shared head and its own
    tail; the other 5 then splice it, and the duplicates of request 0 share
    its mid-page boundary page and copy it on their first write. Needs
    prefix hits, copies, preemption and spills, and token-identical
    output. Returns every entry's launches."""
    import repro_torch.kernels as ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg4 = dataclasses.replace(cfg, num_layers=4)
    model4 = make_model(torch, cfg4, torch.float32, dev, seed)

    def reqs():
        rs = prefix_requests(6, 16, cfg.vocab_size, seed + 6,
                             PREFIX_PARITY["tails"])
        dup = rs[0].prompt[:PREFIX_TOKENS + PREFIX_PARITY["dup_tail"]]
        for i in PREFIX_PARITY["dups"]:
            rs[i].prompt = dup.copy()
        return rs
    ref = engine(model4, dev, hbm=1 << 30, max_len=PREFIX_MAX_LEN
                 ).generate_sequential(reqs())
    got = reqs()
    group = model4.cache_descriptor(16).page_group_bytes
    eng = engine(model4, dev, hbm=PREFIX_PARITY["pages"] * group,
                 max_len=PREFIX_MAX_LEN, prefix_tokens=4096)
    ops.reset_launch_counts()
    eng.generate(got[:1])
    eng.generate(got[1:])
    torch.cuda.synchronize()
    counts = launch_counts(ops)
    s = eng.stats()
    if s["prefix_hits"] <= 0 or s["cow_copies"] <= 0 or s["preempts"] <= 0 \
            or s["pool_page_spills"] <= 0:
        raise AssertionError(
            f"prefix-parity: hits {s['prefix_hits']}, cow_copies "
            f"{s['cow_copies']}, preempts {s['preempts']}, spills "
            f"{s['pool_page_spills']}")
    check_identical(torch, model4, got, ref, "prefix-parity",
                    max_len=PREFIX_MAX_LEN)
    log(f"[serve-prefix] 4-layer fp32 tight pool ({eng.tiered.pool_pages} "
        f"pages) with the prefix cache: token-identical to "
        f"generate_sequential(), prefix_hits {s['prefix_hits']}, "
        f"prefix_tokens_reused {s['prefix_tokens_reused']}, cow_copies "
        f"{s['cow_copies']}, shared_pages {s['shared_pages']}, preempts "
        f"{s['preempts']}, pool_page_spills {s['pool_page_spills']}")
    del model4, eng
    free(torch)
    return counts


CRASH_TICK = 8              # mid-run: after the prompts, inside decode
# the lossy run: unfused ticks on a 50-page pool (max_pages 35 + 15) spill
# pages of running rows; every fault-in is lost or slowed with this rate
LOSS = dict(pages=50, rate=0.5, seed=0)


def crash_recover(torch, dev, seed, cfg):
    """Phase 13: 4 layers at full width in fp32. A journaled run crashed at
    ``CRASH_TICK`` and recovered by a fresh engine sharing the journal;
    then an unfused lossy run (lost spilled pages, failing and stalled
    async transfers). Both against the sequential reference. Returns every
    entry's launches over both runs."""
    import repro_torch.kernels as ops
    from repro_torch.serving.faults import CrashFault, FaultEvent, FaultPlan
    from repro_torch.serving.journal import ServingJournal
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg4 = dataclasses.replace(cfg, num_layers=4)
    model4 = make_model(torch, cfg4, torch.float32, dev, seed)
    ref = reference(torch, model4, dev,
                    requests(4, 64, 400, 16, cfg.vocab_size, seed + 2), None)
    served = collections.Counter()
    journal = ServingJournal()
    plan = FaultPlan(script=(FaultEvent(CRASH_TICK, "crash"),))
    ops.reset_launch_counts()
    try:
        engine(model4, dev, hbm=1 << 30, journal=journal,
               fault_plan=plan).generate(
            requests(4, 64, 400, 16, cfg.vocab_size, seed + 2))
    except CrashFault:
        pass
    else:
        raise AssertionError("crash-recover: the fault plan did not crash")
    state, tick = journal.replay()
    if tick != CRASH_TICK or not any(0 < len(t) < 16
                                     for t in state.values()):
        raise AssertionError(f"crash-recover: journal at tick {tick} holds "
                             f"{ {r: len(t) for r, t in state.items()} }")
    got = requests(4, 64, 400, 16, cfg.vocab_size, seed + 2)
    eng = engine(model4, dev, hbm=1 << 30, journal=journal)
    eng.recover(got)
    torch.cuda.synchronize()
    served.update(launch_counts(ops))
    check_identical(torch, model4, got, ref, "crash-recover")
    s = eng.stats()
    log(f"[crash-recover] 4-layer fp32: crashed at tick {tick} with "
        f"{ {r: len(t) for r, t in sorted(state.items())} } tokens "
        f"journaled; a fresh engine recovered to generate_sequential()'s "
        f"tokens (journal_appends {s['journal_appends']}, journal_bytes "
        f"{s['journal_bytes']}, resumed ticks {s['sched_ticks']})")
    got = requests(4, 64, 400, 16, cfg.vocab_size, seed + 2)
    group = model4.cache_descriptor(16).page_group_bytes
    rate = LOSS["rate"]
    eng = engine(model4, dev, hbm=LOSS["pages"] * group, fuse=False,
                 async_tiering=True, fault_plan=FaultPlan(
                     seed=LOSS["seed"], page_loss_rate=rate,
                     transfer_fail_rate=rate, transfer_delay_rate=rate,
                     script=(FaultEvent(3, "shard_stall", 1, 1e-3),)))
    ops.reset_launch_counts()
    eng.generate(got)
    torch.cuda.synchronize()
    served.update(launch_counts(ops))
    s = eng.stats()
    if s["host_pages_lost"] <= 0 or s["sched_rows_shed"] <= 0:
        raise AssertionError(f"crash-recover: no page lost "
                             f"({s['host_pages_lost']}, shed "
                             f"{s['sched_rows_shed']}, spills "
                             f"{s['pool_page_spills']})")
    check_identical(torch, model4, got, ref, "crash-recover-lossy")
    log(f"[crash-recover] 4-layer fp32 unfused, {eng.tiered.pool_pages}-page "
        f"pool, fault rate {rate}: token-identical with host_pages_lost "
        f"{s['host_pages_lost']}, rows shed {s['sched_rows_shed']}, "
        f"pool_faults {s['pool_faults']}, transfer_retries "
        f"{s['transfer_retries']}, transfer_failures "
        f"{s['transfer_failures']}, degraded ticks "
        f"{s['sched_degraded_ticks']}, preempts {s['preempts']}")
    del model4, eng
    free(torch)
    return served


# ---------------------------------------------------------- phases 16-17
#: parity-mirror's preempting run: prompt lengths and the hot-window budget
#: in tokens (the schedule follows lengths and budget, not width: chosen at
#: smoke width on the CPU, held here)
MIRROR_TIGHT = dict(lens=(300, 120, 64, 220), hot_tokens=300)
MIRROR_COUNTERS = ("log_appends", "page_appends", "drained", "patches",
                   "hot_hits", "routed_log", "routed_pages", "stall_time",
                   "host_writes", "hbm_misses")


def mirror_check(what, eng, counts):
    """The mirror path's invariants: no kernel entry launched, and the
    engine on the mirror."""
    launched = {k: n for k, n in counts.items() if n}
    if eng.pooled or launched:
        raise AssertionError(f"{what}: pooled={eng.pooled}, kernel "
                             f"launches {launched}")


def time_mirror(torch, eng):
    """Split a mirror run's host clock: the engine's mirror calls (on-card
    gather, device→host copy, host-tier appends; each entered after a
    ``torch.cuda.synchronize()``, so the step's queued card work is not
    charged to them) and, inside them, the host-tier engine's appends.
    Returns the dict the wrappers add seconds to."""
    spent = {"mirror_s": 0.0, "engine_s": 0.0}
    depth = {"mirror_s": 0, "engine_s": 0}    # count outermost calls only

    def wrap(obj, name, key, sync):
        fn = getattr(obj, name)

        def timed(*a, **kw):
            if depth[key]:
                return fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            depth[key] += 1
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t
                depth[key] -= 1
        setattr(obj, name, timed)
    for name in ("_mirror_prefill", "_mirror_step_ragged",
                 "mirror_decode_batch"):
        wrap(eng, name, "mirror_s", True)
    for name in ("append", "append_many"):
        wrap(eng.tiered, name, "engine_s", False)
    return spent


def serve_mirror(torch, dev, seed, what, model, kv_engine):
    """Phases 16a–c: phase 3's workload through the dense mirror on
    ``kv_engine`` (``paged`` with ``paged_decode=False``), with the launch
    counts set to 0 just before and read just after. Every token whose KV
    was computed — each prompt's and each generated token's, plus the
    tokens a restore re-appends — reaches the engine's host tiers. Logs
    the wall split of :func:`time_mirror`. Returns every entry's launches
    (all 0)."""
    import repro_torch.kernels as ops
    cfg = model.cfg
    reqs = requests(8, 64, 512, 32, cfg.vocab_size, seed)
    eng = engine(model, dev, hbm=1 << 30, kv_engine=kv_engine,
                 paged_decode=False)
    spent = time_mirror(torch, eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(ops)
    mirror_check(what, eng, counts)
    s = eng.stats()
    if not all(r.done and len(r.generated) == 32 for r in reqs) or not all(
            0 <= t < cfg.vocab_size for r in reqs for t in r.generated):
        raise AssertionError(f"{what}: a request did not finish in vocab")
    if s["mirror_d2h_bytes"] <= 0:
        raise AssertionError(f"{what}: no mirror bytes")
    token_group = eng.tiered.spec.token_bytes * cfg.num_layers
    computed = sum(len(r.prompt) + r.max_new for r in reqs) \
        + s["restore_in_bytes"] // token_group
    landed = {"log": s.get("log_appends", 0),
              "kvhybrid": s.get("log_appends", 0) + s.get("page_appends", 0),
              "paged": s.get("host_writes", 0) // cfg.num_layers}[kv_engine]
    if landed != computed:
        raise AssertionError(f"{what}: {landed} tokens reached the engine, "
                             f"{computed} were computed")
    new = sum(len(r.generated) for r in reqs)
    tier = {k: s[k] for k in MIRROR_COUNTERS if k in s}
    log(f"[{what}] {cfg.name} {cfg.num_layers} layers, {model.dtype}, "
        f"{kv_engine} engine, dense mirror: {len(reqs)} requests, {new} new "
        f"tokens in {wall:.3f} s = {new / wall:.2f} tok/s (incl. prefill); "
        f"ticks {s['sched_ticks']} ({wall / s['sched_ticks'] * 1e3:.1f} ms "
        f"a tick; of the wall, mirror calls {spent['mirror_s']:.3f} s, of "
        f"them host-tier appends {spent['engine_s']:.3f} s), "
        f"mirror_d2h_bytes {s['mirror_d2h_bytes']}, tokens landed "
        f"{landed} of {computed} computed, {tier}, preempts {s['preempts']}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"sim_time_s {s['sim_time_s']}; kernel launches 0")
    return counts


def mirror_run(torch, model, dev, reqs, what, **kw):
    """``generate()`` through the dense mirror with the launch counts set
    to 0 just before and read just after; checks no kernel launched and
    returns (requests, stats, every entry's launches)."""
    import repro_torch.kernels as ops
    eng = engine(model, dev, paged_decode=False, **kw)
    ops.reset_launch_counts()
    eng.generate(reqs)
    torch.cuda.synchronize()
    counts = launch_counts(ops)
    mirror_check(what, eng, counts)
    return reqs, eng.stats(), counts


def parity_mirror(torch, dev, seed, dense, mla):
    """Phase 17: 4 layers at full width in fp32 through the dense mirror,
    token-identical to the pooled ``generate()`` and the sequential
    reference: dense on ``log``, ``kvhybrid`` and ``paged`` (host mode),
    fused and unfused; int8 (the chunk-aware reference) and MLA on
    ``log``; ``log`` with ``speculate_k`` drafts; ``log`` on a hot-window
    budget that preempts. Returns every entry's launches (all 0)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    served = collections.Counter()

    def reqs(cfg):
        return requests(4, 64, 400, 16, cfg.vocab_size, seed + 2)

    for cfg, kd, first, runs in (
            (dense, "native", None, [(e, f) for e in ("log", "kvhybrid",
                                                      "paged")
                                     for f in (True, False)]),
            (dense, "int8", CHUNK, [("log", True)]),
            (mla, "native", None, [("log", True)])):
        cfg4 = dataclasses.replace(cfg, num_layers=4)
        model4 = make_model(torch, cfg4, torch.float32, dev, seed, kd)
        ref = reference(torch, model4, dev, reqs(cfg), first)
        pooled = engine(model4, dev, hbm=1 << 30).generate(reqs(cfg))
        check_identical(torch, model4, pooled, ref, "parity-mirror-pooled",
                        first)
        for kv_engine, fuse in runs:
            what = (f"parity-mirror-{kv_engine}-"
                    f"{'fused' if fuse else 'unfused'}-{kd if kd != 'native' else ('mla' if cfg.mla else 'dense')}")
            got, s, counts = mirror_run(torch, model4, dev, reqs(cfg), what,
                                        hbm=1 << 30, kv_engine=kv_engine,
                                        fuse=fuse)
            served.update(counts)
            check_identical(torch, model4, got, ref, what, first)
            check_identical(torch, model4, got, pooled, what + "-vs-pooled",
                            first)
            log(f"[{what}] 4-layer fp32: generate() == pooled generate() "
                f"== {'generate_sequential()' if first is None else 'the chunk-aware sequential reference'}"
                f" on {len(got)} requests x 16 tokens; ticks "
                f"{s['sched_ticks']}, mirror_d2h_bytes "
                f"{s['mirror_d2h_bytes']}, kernel launches 0")
        if cfg is dense and kd == "native":
            got, s, counts = mirror_run(
                torch, model4, dev, reqs(cfg), "parity-mirror-spec",
                hbm=1 << 30, kv_engine="log", speculate_k=SPEC_K,
                draft_proposer=ReferenceDrafts(ref, 2, cfg.vocab_size))
            served.update(counts)
            if not 0 < s["spec_accepted"] < s["spec_proposed"]:
                raise AssertionError(f"parity-mirror-spec: accepted "
                                     f"{s['spec_accepted']} of "
                                     f"{s['spec_proposed']}")
            check_identical(torch, model4, got, ref, "parity-mirror-spec")
            log(f"[parity-mirror-spec] 4-layer fp32 log, speculate_k "
                f"{SPEC_K}: token-identical; spec_proposed "
                f"{s['spec_proposed']}, spec_accepted {s['spec_accepted']}, "
                f"ticks {s['sched_ticks']}, mirror_d2h_bytes "
                f"{s['mirror_d2h_bytes']}")
            lens = MIRROR_TIGHT["lens"]
            tref = reference(torch, model4, dev,
                             requests_of(lens, 16, cfg.vocab_size, seed + 3),
                             None)
            per_token = 4 * 2 * cfg.num_kv_heads * cfg.head_dim * 2
            got, s, counts = mirror_run(
                torch, model4, dev,
                requests_of(lens, 16, cfg.vocab_size, seed + 3),
                "parity-mirror-tight", kv_engine="log",
                hbm=MIRROR_TIGHT["hot_tokens"] * per_token)
            served.update(counts)
            if s["preempts"] <= 0 or s["restores"] != s["preempts"]:
                raise AssertionError(f"parity-mirror-tight: preempts "
                                     f"{s['preempts']}, restores "
                                     f"{s['restores']}")
            check_identical(torch, model4, got, tref, "parity-mirror-tight")
            log(f"[parity-mirror-tight] 4-layer fp32 log, hot-window budget "
                f"{MIRROR_TIGHT['hot_tokens']} tokens, prompts {lens}: "
                f"token-identical with {s['preempts']} preempts and "
                f"{s['restores']} restores ({s['preempt_out_bytes']} B out "
                f"to disk), ticks {s['sched_ticks']}")
        del model4
        free(torch)
    return served


# ---------------------------------------------------------- phases 18-19
# phase 18: (phase, config, layers kept or None for all, the entry its
# fused tick runs)
FAMILY_SERVE = (
    ("serve-deepseek-moe", "deepseek-v2-236b", 8,
     "mla_paged_attention_ragged"),
    ("serve-arctic", "arctic-480b", 2, "paged_attention_ragged"),
    ("serve-gemma", "gemma-7b", None, "paged_attention_ragged"),
    ("serve-minicpm", "minicpm-2b", None, "paged_attention_ragged"),
    ("serve-starcoder2", "starcoder2-15b", None, "paged_attention_ragged"))
# phase 19: (config, layers kept), the MoE ones at no-drop capacity
FAMILY_PARITY = (("deepseek-v2-236b", 3), ("arctic-480b", 1),
                 ("gemma-7b", 4), ("minicpm-2b", 4), ("starcoder2-15b", 4))


def cut(cfg, layers, no_drop=False):
    """``cfg`` with ``layers`` layers (all when None); ``no_drop`` sets a
    MoE config's capacity factor to its expert count, so no token is
    dropped."""
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if no_drop and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    return cfg


def weight_gb(model):
    return sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9


def serve_families(torch, dev, seed, rows):
    """Phase 18: phase 3's workload on each of ``FAMILY_SERVE``'s configs at
    published widths in bf16 (DeepSeek-V2 and Arctic cut in depth to fit
    the card, at the published capacity factor), each model freed before
    the next. Returns every entry's launches over the phases."""
    import repro_torch.kernels as ops
    from repro_torch.configs import get_config
    served = collections.Counter()
    for what, arch, layers, entry in FAMILY_SERVE:
        t0 = time.perf_counter()
        model = make_model(torch, cut(get_config(arch), layers),
                           torch.bfloat16, dev, seed)
        torch.cuda.synchronize()
        log(f"[{what}] weights {weight_gb(model):.2f} GB drawn in "
            f"{time.perf_counter() - t0:.1f} s")
        launches, _, counts = serve(torch, dev, seed, what, model,
                                    getattr(ops, entry))
        rows[entry].setdefault("family_launches", {})[what] = launches
        served.update(counts)
        del model
        free(torch)
    return served


def parity_families(torch, dev, seed):
    """Phase 19: fp32, ``FAMILY_PARITY``'s configs at published widths, cut
    in depth, the MoE ones at no-drop capacity: ``generate()`` (pooled,
    fused, through the family's ragged entry) token-identical to
    ``generate_sequential()``. Returns every entry's launches over the
    ``generate()`` runs."""
    import repro_torch.kernels as ops
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    served = collections.Counter()
    for arch, layers in FAMILY_PARITY:
        what = f"parity-{arch}"
        cfg = cut(get_config(arch), layers, no_drop=True)
        model = make_model(torch, cfg, torch.float32, dev, seed)
        entry = (ops.mla_paged_attention_ragged if cfg.mla is not None
                 else ops.paged_attention_ragged)
        ref = engine(model, dev, hbm=1 << 30).generate_sequential(
            requests(4, 64, 400, 16, cfg.vocab_size, seed + 1))
        got = requests(4, 64, 400, 16, cfg.vocab_size, seed + 1)
        eng = engine(model, dev, hbm=1 << 30)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        eng.generate(got)
        torch.cuda.synchronize()
        counts = launch_counts(ops)
        others = launched_besides(counts, entry.__name__)
        s = eng.stats()
        if counts[entry.__name__] != cfg.num_layers * s["step_calls"] \
                or others:
            raise AssertionError(f"{what}: {counts[entry.__name__]} "
                                 f"{entry.__name__} launches for "
                                 f"{s['step_calls']} steps; others {others}")
        check_identical(torch, model, got, ref, what)
        served.update(counts)
        moe = (f", capacity factor {cfg.moe.capacity_factor} (no drop)"
               if cfg.moe is not None else "")
        log(f"[{what}] {cfg.num_layers} layers fp32{moe}, "
            f"{weight_gb(model):.2f} GB of weights, {eng.desc.family} pool: "
            f"generate() == generate_sequential() on {len(got)} requests x "
            f"16 tokens (ticks {s['sched_ticks']}, {entry.__name__} "
            f"launches {counts[entry.__name__]}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
        del model, eng
        free(torch)
    return served


# ---------------------------------------------------------- phases 20-23
# serve-zamba2's requests: the long prompts (prefilled whole, past the
# 512-token chunk_size: through #9) and two short ones (plain attention)
ZAMBA2_PROMPTS = LONG_PROMPTS + (256, 64)
# parity-hybrid: Zamba2 cut to 2 segments of 6 (both shared blocks) and a
# tail of 2; one prompt past chunk_size
HYBRID_PARITY_LAYERS, HYBRID_PARITY_PROMPTS = 14, (1100, 200, 64)


def serve_mamba2(torch, dev, seed):
    """Phase 20: Mamba-2 1.3B (48 layers, published widths, bf16) through
    phase 3's workload on the ``paged`` engine at 1 GiB: pooled, fused and
    mirror-free, its cache one state row per sequence beside the block
    tables; no kernel entry runs (the reference's SSD scan is XLA).
    Returns every entry's launches."""
    import repro_torch.kernels as ops
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    model = make_model(torch, get_config("mamba2-1.3b"), torch.bfloat16,
                       dev, seed)
    cfg = model.cfg
    torch.cuda.synchronize()
    log(f"[serve-mamba2] weights {weight_gb(model):.2f} GB drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = requests(8, 64, 512, 32, cfg.vocab_size, seed)
    eng = engine(model, dev, hbm=1 << 30)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(ops)
    s = eng.stats()
    desc = eng.desc
    if not (eng.pooled and eng.fused and desc.family == "ssm"
            and eng.tiered.pool_pages == 0):
        raise AssertionError(f"serve-mamba2: pooled {eng.pooled}, fused "
                             f"{eng.fused}, family {desc.family}")
    if not all(r.done and len(r.generated) == 32 for r in reqs) or not all(
            0 <= t < cfg.vocab_size for r in reqs for t in r.generated):
        raise AssertionError("serve-mamba2: a request did not finish in "
                             "vocab")
    if s["mirror_d2h_bytes"] != 0 or any(counts.values()):
        raise AssertionError(f"serve-mamba2: mirror bytes "
                             f"{s['mirror_d2h_bytes']}, launches {counts}")
    new = sum(len(r.generated) for r in reqs)
    log(f"[serve-mamba2] {cfg.name} {cfg.num_layers} layers, {model.dtype}, "
        f"ssm state rows: {len(reqs)} requests, prompts "
        f"{[len(r.prompt) for r in reqs]}, {new} new tokens in {wall:.3f} s "
        f"= {new / wall:.2f} tok/s (incl. prefill); ticks {s['sched_ticks']}"
        f" (fused {s['fused_steps']}), prefill chunks "
        f"{s['sched_prefill_chunks']}, preempts {s['preempts']}, "
        f"mirror_d2h_bytes {s['mirror_d2h_bytes']}, kernel launches 0, "
        f"state rows {eng.tiered._state_capacity} at 1 GiB of "
        f"seq_state_bytes {desc.seq_state_bytes} (conv "
        f"{desc.num_layers * desc.seq_planes[0].entry_bytes} + ssm "
        f"{desc.num_layers * desc.seq_planes[1].entry_bytes}), pool_appends "
        f"{s['pool_appends']}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, eng
    free(torch)
    return counts


def serve_zamba2(torch, dev, seed):
    """Phase 21: Zamba2-1.2B (all 38 layers, published widths, bf16) on
    the ``paged`` engine, where it falls back to the dense mirror (no
    cache descriptor), unfused, whole-prompt prefill of
    ``ZAMBA2_PROMPTS``: each prompt past the 512-token chunk_size runs
    #9 once per shared-block invocation (6). Returns every entry's
    launches."""
    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    model = make_model(torch, get_config("zamba2-1.2b"), torch.bfloat16,
                       dev, seed)
    cfg = model.cfg
    torch.cuda.synchronize()
    log(f"[serve-zamba2] weights {weight_gb(model):.2f} GB drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = requests_of(ZAMBA2_PROMPTS, 32, cfg.vocab_size, seed)
    max_len = -(-(max(ZAMBA2_PROMPTS) + 32 + 1) // 16) * 16
    eng = engine(model, dev, hbm=1 << 30, max_len=max_len, chunk=None)
    prefill_ms = {}
    admit = eng.prefill_one

    def timed_prefill(req, *a, **kw):      # host clock around synced work
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = admit(req, *a, **kw)
        torch.cuda.synchronize()
        prefill_ms[req.rid] = (time.perf_counter() - t) * 1e3
        return out
    eng.prefill_one = timed_prefill
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(K)
    s = eng.stats()
    n_long = sum(n > model.chunk_size for n in ZAMBA2_PROMPTS)
    n_seg = cfg.num_layers // cfg.hybrid.shared_block_period
    flash = counts["flash_attention"]
    others = {k: n for k, n in counts.items() if n and k != "flash_attention"}
    if eng.pooled or eng.fused or eng.desc is not None:
        raise AssertionError(f"serve-zamba2: pooled {eng.pooled}, fused "
                             f"{eng.fused}")
    if not all(r.done and len(r.generated) == 32 for r in reqs) or not all(
            0 <= t < cfg.vocab_size for r in reqs for t in r.generated):
        raise AssertionError("serve-zamba2: a request did not finish in "
                             "vocab")
    if flash != n_seg * n_long or others or s["mirror_d2h_bytes"] != 0:
        raise AssertionError(f"serve-zamba2: {flash} flash launches for "
                             f"{n_long} long prompts x {n_seg} segments; "
                             f"others {others}; mirror bytes "
                             f"{s['mirror_d2h_bytes']}")
    new = sum(len(r.generated) for r in reqs)
    log(f"[serve-zamba2] {cfg.name} {cfg.num_layers} layers ({n_seg} "
        f"segments of {cfg.hybrid.shared_block_period} + tail "
        f"{model.tail_len}), {model.dtype}, dense mirror (unfused): prompts "
        f"{list(ZAMBA2_PROMPTS)} prefilled whole, {new} new tokens in "
        f"{wall:.3f} s = {new / wall:.2f} tok/s (incl. prefill); prefill ms "
        f"per request { {r.rid: round(prefill_ms[r.rid], 3) for r in reqs} };"
        f" ticks {s['sched_ticks']}, step_calls {s['step_calls']}, "
        f"flash_attention launches {flash} (= {n_seg} x {n_long}), "
        f"mirror_d2h_bytes {s['mirror_d2h_bytes']}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, eng
    free(torch)
    return counts


def parity_ssm(torch, dev, seed):
    """Phase 22: fp32 Mamba-2 at published widths cut to 4 layers: pooled,
    fused ``generate()`` with 5-token prefill chunks, ``speculate_k`` 2
    (``ReferenceDrafts`` with the second draft wrong, so a decode row
    commits a middle slot's state) and a budget of 2 state rows that
    preempts, against ``generate_sequential()``."""
    import repro_torch.kernels as ops
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cut(get_config("mamba2-1.3b"), 4)
    model = make_model(torch, cfg, torch.float32, dev, seed)
    ref = engine(model, dev, hbm=1 << 30).generate_sequential(
        requests(4, 64, 400, 16, cfg.vocab_size, seed + 1))
    got = requests(4, 64, 400, 16, cfg.vocab_size, seed + 1)
    desc = model.cache_descriptor(16)
    eng = engine(model, dev, hbm=2 * desc.seq_state_bytes, chunk=5,
                 speculate_k=2,
                 draft_proposer=ReferenceDrafts(ref, 1, cfg.vocab_size))
    ops.reset_launch_counts()
    eng.generate(got)
    torch.cuda.synchronize()
    counts = launch_counts(ops)
    s = eng.stats()
    if not eng.pooled or s["preempts"] <= 0 or any(counts.values()) \
            or not 0 < s["spec_accepted"] < s["spec_proposed"]:
        raise AssertionError(f"parity-ssm: pooled {eng.pooled}, preempts "
                             f"{s['preempts']}, launches {counts}, accepted "
                             f"{s['spec_accepted']} of {s['spec_proposed']}")
    check_identical(torch, model, got, ref, "parity-ssm")
    log(f"[parity-ssm] {cfg.name} {cfg.num_layers} layers fp32 state rows "
        f"(2-row budget): generate() == generate_sequential() on {len(got)} "
        f"requests x 16 tokens, 5-token chunks, speculate_k 2 (accepted "
        f"{s['spec_accepted']} of {s['spec_proposed']}), {s['preempts']} "
        f"preempts, ticks {s['sched_ticks']}")
    del model, eng
    free(torch)
    return counts


def parity_hybrid(torch, dev, seed):
    """Phase 23: fp32 Zamba2 at published widths cut to
    ``HYBRID_PARITY_LAYERS`` layers (2 segments, both shared blocks, a
    tail of 2): ``generate()`` on the mirror, a prompt past chunk_size
    prefilled whole through #9, against ``generate_sequential()``."""
    import repro_torch.kernels as ops
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cut(get_config("zamba2-1.2b"), HYBRID_PARITY_LAYERS)
    model = make_model(torch, cfg, torch.float32, dev, seed)
    max_len = -(-(max(HYBRID_PARITY_PROMPTS) + 8 + 1) // 16) * 16
    if (model.n_seg, model.tail_len, len(model.shared_blocks)) != (2, 2, 2):
        raise AssertionError("parity-hybrid: the cut lost its structure")
    ref = engine(model, dev, hbm=1 << 30, max_len=max_len, chunk=None
                 ).generate_sequential(requests_of(
                     HYBRID_PARITY_PROMPTS, 8, cfg.vocab_size, seed + 3))
    got = requests_of(HYBRID_PARITY_PROMPTS, 8, cfg.vocab_size, seed + 3)
    eng = engine(model, dev, hbm=1 << 30, max_len=max_len, chunk=None)
    ops.reset_launch_counts()
    eng.generate(got)
    torch.cuda.synchronize()
    counts = launch_counts(ops)
    n_long = sum(n > model.chunk_size for n in HYBRID_PARITY_PROMPTS)
    others = {k: n for k, n in counts.items() if n and k != "flash_attention"}
    if counts["flash_attention"] != model.n_seg * n_long or others:
        raise AssertionError(f"parity-hybrid: launches {counts}")
    check_identical(torch, model, got, ref, "parity-hybrid",
                    max_len=max_len)
    log(f"[parity-hybrid] {cfg.name} {cfg.num_layers} layers fp32 (2 "
        f"segments, both shared blocks, tail 2): generate() == "
        f"generate_sequential() on prompts {list(HYBRID_PARITY_PROMPTS)} x "
        f"8 tokens (flash launches {counts['flash_attention']}, ticks "
        f"{eng.stats()['sched_ticks']})")
    del model, eng
    free(torch)
    return counts


# ---------------------------------------------------------- phases 24-29
# Seamless-M4T v2: 4096 frames of width d_model and two text prompts (the
# 600-token one takes the decoder's self- and cross-attention past
# chunk_size); LLaVA-NeXT: 2880 image patches and 64 text tokens
ENCDEC_FRAMES, ENCDEC_PROMPTS = 4096, (64, 600)
VLM_IMAGE, VLM_PROMPTS = 2880, (64,)
MODEL_STEPS, PARITY_STEPS = 32, 8
FRONTEND_PARITY_LAYERS = 4


def frontend_inputs(torch, cfg, dev, seed, n_text):
    """A text prompt of ``n_text`` tokens (numpy, from ``seed``) and the
    frontend embeddings drawn on the card: Seamless's ``ENCDEC_FRAMES``
    frames of width d_model, or LLaVA's ``VLM_IMAGE`` patches of width
    d_frontend."""
    import numpy as np
    toks = np.random.default_rng(seed + n_text).integers(
        0, cfg.vocab_size, (1, n_text), dtype=np.int64)
    shape = ((1, ENCDEC_FRAMES, cfg.d_model) if cfg.family == "encdec"
             else (1, VLM_IMAGE, cfg.frontend.d_frontend))
    fe = torch.randn(shape, generator=torch.Generator(dev).manual_seed(seed),
                     device=dev)
    return torch.as_tensor(toks, device=dev), fe


def frontend_len(cfg, n_text):
    """The decoder's prompt length: the image patches and the text for the
    VLM, the text for the encoder-decoder."""
    return n_text + (VLM_IMAGE if cfg.family == "vlm" else 0)


def expected_flash(model, n_text, steps):
    """#9's launches in a prefill of ``n_text`` tokens and ``steps``
    decode steps, by the model's own lengths and ``chunk_size``: the
    encoder, cross-attention and decoder self-attention each launch once a
    layer past it (a decode step's cross-attention past the default 512,
    as in the reference); the VLM's decoder once a layer past it."""
    cfg, chunk = model.cfg, model.chunk_size
    S = frontend_len(cfg, n_text)
    if cfg.family == "vlm":
        return cfg.num_layers * (S > chunk), 0
    prefill = (cfg.num_encoder_layers * (ENCDEC_FRAMES > chunk)
               + cfg.num_layers * (max(S, ENCDEC_FRAMES) > chunk)
               + cfg.num_layers * (S > chunk))
    return prefill, cfg.num_layers * steps * (ENCDEC_FRAMES > 512)


def greedy(torch, model, toks, fe, steps, keep_prefill=False):
    """``LM.prefill`` then ``steps`` greedy ``decode_step``s, each timed on
    the host clock after a sync, the tokens kept on the card until the
    end. Returns (tokens, the logits each token was picked from, the
    prefill's (logits, cache) when ``keep_prefill`` (a copy: decode writes
    the cache in place) else the last step's, prefill ms, ms per decode
    step)."""
    max_len = frontend_len(model.cfg, toks.shape[1]) + steps + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(toks, max_len, frontend_embeds=fe)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    first = ((logits, {k: v.clone() for k, v in cache.items()})
             if keep_prefill else None)
    picked, seen = [], []
    for _ in range(steps):
        seen.append(logits[0, -1])
        picked.append(logits[:, -1].argmax(-1, keepdim=True))
        logits, cache = model.decode_step(cache, picked[-1], cache["pos"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tokens = torch.cat(picked, 1)[0].tolist() if picked else []
    return (tokens, seen, first or (logits, cache), (t1 - t0) * 1e3,
            (t2 - t1) * 1e3 / max(steps, 1))


def model_frontend(torch, dev, seed, what, arch, prompts):
    """Phases 26-27: ``arch`` at published widths in bf16 (random weights
    from ``seed``), B = 1: for each text prompt, ``LM.prefill`` with its
    frontend embeddings and ``MODEL_STEPS`` greedy decode steps, with the
    launch counts set to 0 just before and read after the prefill and
    after the steps. Returns every entry's launches."""
    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    model = make_model(torch, get_config(arch), torch.bfloat16, dev, seed)
    cfg = model.cfg
    torch.cuda.synchronize()
    log(f"[{what}] weights {weight_gb(model):.2f} GB drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    served = collections.Counter()
    for n in prompts:
        toks, fe = frontend_inputs(torch, cfg, dev, seed, n)
        want = expected_flash(model, n, MODEL_STEPS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        tokens, _, (logits, cache), pre_ms, step_ms = greedy(
            torch, model, toks, fe, MODEL_STEPS)
        counts = launch_counts(K)
        flash = counts["flash_attention"]
        others = {k: c for k, c in counts.items() if c and
                  k != "flash_attention"}
        S = frontend_len(cfg, n)
        if flash != sum(want) or others:
            raise AssertionError(f"{what}: {flash} flash launches (expected "
                                 f"{want[0]} + {want[1]}); others {others}")
        if len(tokens) != MODEL_STEPS or not all(
                0 <= t < cfg.vocab_size for t in tokens) or not bool(
                torch.isfinite(logits[..., :cfg.vocab_size]).all()):
            raise AssertionError(f"{what}: tokens {tokens}")
        if cache["k"].shape[:3] != (cfg.num_layers, 1, S + MODEL_STEPS + 1) \
                or int(cache["pos"][0]) != S + MODEL_STEPS:
            raise AssertionError(f"{what}: cache {tuple(cache['k'].shape)}, "
                                 f"pos {cache['pos'].tolist()}")
        served.update(counts)
        enc = (f"{cfg.num_encoder_layers} encoder layers over "
               f"{ENCDEC_FRAMES} frames, " if cfg.family == "encdec"
               else f"{VLM_IMAGE} image tokens + ")
        log(f"[{what}] {cfg.name} {enc}{cfg.num_layers} decoder layers, "
            f"{model.dtype}, a {n}-token text prompt: prefill {pre_ms:.3f} "
            f"ms, {MODEL_STEPS} greedy decode steps at {step_ms:.3f} ms a "
            f"step, flash_attention launches {flash} (prefill {want[0]}, "
            f"decode {want[1]}), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model
    free(torch)
    return served


def parity_frontend(torch, dev, seed, what, arch, prompts):
    """Phases 28-29: fp32, ``arch`` at published widths cut to
    ``FRONTEND_PARITY_LAYERS`` layers (encoder and decoder), phases 26-27's
    inputs: ``LM.prefill`` through #9 against the same model's plain
    branch (``chunk_size`` past every length: ``full_attention``; a decode
    step's cross-attention, at the default 512 whatever the model's, runs
    #9's plain version) — the last logits and every layer's cache planes
    (``k``/``v``, for the encoder-decoder also ``ek``/``ev``) within fp32
    tolerance — then ``PARITY_STEPS`` greedy decode steps token-identical
    to the plain branch's, a divergence only at its near-tie. Returns
    every entry's launches in the runs through #9."""
    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import attention
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch)
    cfg = dataclasses.replace(
        cfg, num_layers=FRONTEND_PARITY_LAYERS,
        num_encoder_layers=min(cfg.num_encoder_layers,
                               FRONTEND_PARITY_LAYERS))
    model = make_model(torch, cfg, torch.float32, dev, seed)
    planes = ("k", "v") + (("ek", "ev") if cfg.family == "encdec" else ())
    served = collections.Counter()
    for n in prompts:
        toks, fe = frontend_inputs(torch, cfg, dev, seed, n)
        want = expected_flash(model, n, PARITY_STEPS)
        K.reset_launch_counts()
        got = greedy(torch, model, toks, fe, PARITY_STEPS, keep_prefill=True)
        counts = launch_counts(K)
        if counts["flash_attention"] != sum(want) or sum(counts.values()) \
                != counts["flash_attention"] or not want[0]:
            raise AssertionError(f"{what}: launches {counts}, expected "
                                 f"{want}")
        served.update(counts)
        chunk, kernel = model.chunk_size, attention.flash_attention
        model.chunk_size = ENCDEC_FRAMES + frontend_len(cfg, n)
        attention.flash_attention = flash_attention_ref
        try:
            ref = greedy(torch, model, toks, fe, PARITY_STEPS,
                         keep_prefill=True)
        finally:
            model.chunk_size, attention.flash_attention = chunk, kernel
        if any(launch_counts(K)[k] != c for k, c in counts.items()):
            raise AssertionError(f"{what}: the plain branch launched a "
                                 f"kernel")
        errs = compare_planes(torch, what, f"{n}-token prefill", got[2],
                              ref[2], planes)
        if got[0] != ref[0]:
            step = next(i for i, (a, b) in enumerate(zip(got[0], ref[0]))
                        if a != b)
            lv = ref[1][step][:cfg.vocab_size].double()
            top = torch.topk(lv, 2).values
            margin, std = float(top[0] - top[1]), float(lv.std())
            log(f"[{what}] differs at step {step}: reference top-2 margin "
                f"{margin:.3e}, logit std {std:.3e}")
            if margin >= 1e-4 * std:
                raise AssertionError(f"{what}: diverged at step {step} with "
                                     f"a clear margin")
        log(f"[{what}] {cfg.name} {cfg.num_encoder_layers} + "
            f"{cfg.num_layers} layers fp32, a {n}-token prompt: prefill "
            f"through #9 ({want[0]} launches) == the plain branch within "
            f"fp32 tolerance {errs}; {PARITY_STEPS} greedy decode steps "
            f"identical: {got[0] == ref[0]} ({want[1]} launches)")
        del got, ref
    del model
    free(torch)
    return served


# ------------------------------------------------- the file-system tier
# The paper's fio study (Figs. 3-4), this script's own copy of the
# reference's fio benchmark (its MIXES, Workload, all_workloads,
# gen_offsets and run_workload, run_grid and validate_paper_claims): random
# 4 KiB IOs over a file, four read/write mixes, uniform and Zipf 95/5;
# NVMM-small = file/10, NVMM-large = 5 x file, NVLog's DRAM cache file/10.
# ``sim_time_s`` is the reference's modelled clock (Optane and NVMe
# tiers), never the card's or the host's speed.
FIO_PAGE = 4096
MIXES = {"randr": 1.0, "randrw90": 0.9, "randrw": 0.5, "randw": 0.0}
FIO_SCALE = 32 << 20            # the reference's default --scale
FIO_ENGINES = ("nvpages", "nvlog", "psync", "nvhybrid")


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    read_frac: float
    zipf: bool           # 95% of accesses in 5% of the file
    file_bytes: int
    io_bytes: int
    block: int = FIO_PAGE
    seed: int = 0

    @property
    def n_ops(self) -> int:
        return self.io_bytes // self.block


def all_workloads(file_bytes, io_bytes, seed=0):
    return [Workload(name + ("-zipf" if zipf else ""), rf, zipf, file_bytes,
                     io_bytes, seed=seed)
            for zipf in (False, True) for name, rf in MIXES.items()]


def gen_offsets(wl, rng):
    """Random aligned block offsets; Zipf = 95% of ops in the first 5% of
    the file."""
    import numpy as np
    nblocks = wl.file_bytes // wl.block
    if not wl.zipf:
        return rng.integers(0, nblocks, wl.n_ops) * wl.block
    hot_blocks = max(nblocks // 20, 1)
    hot = rng.random(wl.n_ops) < 0.95
    offs = np.where(hot, rng.integers(0, hot_blocks, wl.n_ops),
                    rng.integers(0, nblocks, wl.n_ops))
    return offs * wl.block


def fio_ops(wl):
    """(offsets, is_read) of one job, drawn from its seed."""
    import numpy as np
    rng = np.random.default_rng(wl.seed)
    offsets = gen_offsets(wl, rng)
    return offsets, rng.random(wl.n_ops) < wl.read_frac


def run_workload(fs, wl):
    """One fio job on a file laid out on "disk" with a warm LPC; returns
    (simulated seconds, wall seconds)."""
    fd = fs.open("/bench/file")
    zero = bytes(FIO_PAGE)
    payload = b"\xA5" * FIO_PAGE
    for off in range(0, wl.file_bytes, FIO_PAGE):
        pno = off // FIO_PAGE
        fs.disk.ssd[pno] = zero
        fs.disk._lpc_insert(pno, bytearray(zero), dirty=False)
    offsets, is_read = fio_ops(wl)
    t_sim0, t_wall0 = fs.simulated_time, time.perf_counter()
    for off, rd in zip(offsets.tolist(), is_read.tolist()):
        if rd:
            fs.pread(fd, wl.block, off)
        else:
            fs.pwrite(fd, payload, off)
    return fs.simulated_time - t_sim0, time.perf_counter() - t_wall0


def run_grid(file_bytes):
    """Every workload x ``FIO_ENGINES`` at both NVMM budgets, one run a
    cell (seed 0, so ``sim_time_std`` is 0.0 as in the reference's rows),
    then psync_fsync's randw job at 1/8 size; each row also keeps the
    job's wall seconds."""
    from repro_torch.core import EngineSpec, NVCacheFS
    nvmm_small = max(file_bytes // 10, 1 << 20)
    nvmm_large = 5 * file_bytes
    dram_cache = max(file_bytes // 10, 1 << 20)

    def cell(figure, nvmm_name, nvmm, wl, workload, engine):
        sim, wall = run_workload(NVCacheFS(EngineSpec(
            engine=engine, nvmm_bytes=nvmm, dram_cache_bytes=dram_cache)), wl)
        return {"figure": figure, "nvmm": nvmm_name, "workload": workload,
                "engine": engine, "sim_time_s": sim, "sim_time_std": 0.0,
                "wall_s": wall}
    results = [cell("fig3" if nvmm_name == "small" else "fig4", nvmm_name,
                    nvmm, wl, wl.name, engine)
               for nvmm_name, nvmm in (("small", nvmm_small),
                                       ("large", nvmm_large))
               for wl in all_workloads(file_bytes, file_bytes)
               for engine in FIO_ENGINES]
    randw = all_workloads(file_bytes // 8, file_bytes // 8)[3]
    results.append(cell("fig3", "small", nvmm_small, randw,
                        "randw(1/8 size)", "psync_fsync"))
    return results


def validate_paper_claims(results):
    """The paper's findings as the reference's fio benchmark checks them:
    PASS/FAIL lines."""
    idx = {(r["figure"], r["workload"], r["engine"]): r["sim_time_s"]
           for r in results}
    checks = []

    def check(name, ok):
        checks.append(("PASS" if ok else "FAIL") + " " + name)

    for fig in ("fig3", "fig4"):
        wins = sum(
            idx[(fig, w, "nvlog")] <= idx[(fig, w, "nvpages")] * 1.05
            for w in ("randr", "randrw", "randrw90", "randw",
                      "randr-zipf", "randrw-zipf", "randrw90-zipf",
                      "randw-zipf"))
        want = 8 if fig == "fig4" else 6       # fig3: zipf-write crossover
        check(f"{fig}: NVLog wins (or ties) nearly every workload "
              f"[{wins}/8]", wins >= want)
    check("randr: NVPages pays NVMM read bandwidth (≥3× NVLog)",
          idx[("fig4", "randr", "nvpages")] >=
          3 * idx[("fig4", "randr", "nvlog")])
    check("psync (no persistence) is the fastest reference on randr",
          idx[("fig3", "randr", "psync")] <=
          min(idx[("fig3", "randr", "nvlog")],
              idx[("fig3", "randr", "nvpages")]) * 1.1)
    fsync = [r for r in results if r["engine"] == "psync_fsync"]
    if fsync:
        check("fsync-per-write ≫ log persistence (paper: >1h vs seconds)",
              fsync[0]["sim_time_s"] * 8 >
              50 * idx[("fig4", "randw", "nvlog")])
    for w in ("randr", "randrw90"):
        zipf_gap = (idx[("fig3", w + "-zipf", "nvpages")]
                    / idx[("fig3", w + "-zipf", "nvlog")])
        uni_gap = (idx[("fig3", w, "nvpages")]
                   / idx[("fig3", w, "nvlog")])
        check(f"zipf narrows the gap on {w} (hot set fits NVPages) "
              f"without flipping it",
              1.0 <= zipf_gap <= uni_gap * 1.05)
    check("documented crossover: fig3 zipf-writes favour paging "
          "(log saturated)",
          idx[("fig3", "randw-zipf", "nvpages")] <
          idx[("fig3", "randw-zipf", "nvlog")])
    return checks


class PeakRss:
    """The peak of this process's resident set over a ``with`` block,
    read from ``/proc/self/statm`` every ``every`` seconds by a thread
    (``ru_maxrss`` is the mark since the process began, and resetting
    ``VmHWM`` may be refused); a peak shorter than ``every`` can be
    missed."""

    def __init__(self, every=0.02):
        import os
        import threading
        self.every, self.page = every, os.sysconf("SC_PAGE_SIZE")
        self.peak, self.stop = 0, threading.Event()
        self.thread = threading.Thread(target=self.watch, daemon=True)

    def sample(self):
        with open("/proc/self/statm") as f:
            self.peak = max(self.peak, int(f.read().split()[1]) * self.page)

    def watch(self):
        while not self.stop.wait(self.every):
            self.sample()

    def __enter__(self):
        self.sample()
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.sample()

    @property
    def gib(self):
        return self.peak / 2**30


def fs_matrix(file_bytes=FIO_SCALE):
    """The paper's Fig. 3/4 grid on the port's ``NVCacheFS`` (host code),
    one run a cell; prints every cell and the paper checks (printed, not
    enforced: the reference's own outcome at this scale is the
    yardstick). Raises if a cell's simulated time is not a positive
    finite number."""
    import math
    t0 = time.perf_counter()
    with PeakRss() as rss:
        results = run_grid(file_bytes)
    wall = time.perf_counter() - t0
    log(f"[fs-matrix] file {file_bytes >> 20} MiB, 1 run a cell "
        f"(sim_time_s is the reference's modelled Optane/NVMe clock, not "
        f"a speed of the port)")
    for r in results:
        if not (math.isfinite(r["sim_time_s"]) and r["sim_time_s"] > 0):
            raise AssertionError(f"fs-matrix: cell {r}")
        log(f"[fs-matrix] {r['figure']},{r['nvmm']},{r['workload']},"
            f"{r['engine']},sim_time_s={r['sim_time_s']!r},"
            f"wall_s={r['wall_s']:.3f}")
    checks = validate_paper_claims(results)
    for c in checks:
        log(f"[fs-matrix] {c}")
    log(f"[fs-matrix] {len(results)} cells in {wall:.1f} s wall, "
        f"{sum(c.startswith('PASS') for c in checks)}/{len(checks)} paper "
        f"checks pass; the phase's peak RSS {rss.gib:.2f} GiB")
    return results, checks


CKPT_DESIGNS = ("paged", "log", "nvhybrid")
CKPT_NEW = 8                        # greedy tokens a served request
CKPT_EDIT = ("final_ln", "head")    # the leaves ckpt-log's delta rewrites


def same_bits(torch, a, b):
    """``a`` and ``b`` hold the same bytes (bf16 included)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def greedy_two(torch, dev, seed, model, what):
    """The serve phase's first two requests, ``CKPT_NEW`` greedy tokens
    each, through the pooled fused path on a 1 GiB pool, with the launch
    counts set to 0 just before and read just after."""
    import repro_torch.kernels as ops
    cfg = model.cfg
    reqs = requests(8, 64, 512, CKPT_NEW, cfg.vocab_size, seed)[:2]
    eng = engine(model, dev, hbm=1 << 30)
    ops.reset_launch_counts()
    eng.generate(reqs)
    torch.cuda.synchronize()
    counts = launch_counts(ops)
    s = eng.stats()
    n = counts["paged_attention_ragged"]
    if n <= 0 or n != cfg.num_layers * s["step_calls"] \
            or launched_besides(counts, "paged_attention_ragged"):
        raise AssertionError(f"{what}: launches {counts} for "
                             f"{s['step_calls']} steps")
    if not all(r.done and len(r.generated) == CKPT_NEW for r in reqs):
        raise AssertionError(f"{what}: a request did not finish")
    return [list(r.generated) for r in reqs], counts


def ckpt(torch, dev, seed, design, model):
    """Save ``model``'s card-resident weights through ``CheckpointManager``
    at its default 1 GiB of NVMM, crash, restore onto a second model drawn
    from another seed on the card, hold every tensor bit for bit, and
    serve the same greedy tokens from both; returns the launches of the
    two serving runs. ``log`` first saves a delta step of ``CKPT_EDIT``,
    edited on the card, and restores that step (the edit is undone
    afterwards)."""
    import gc
    from repro_torch.checkpoint import CheckpointManager
    what = f"ckpt-{design}"
    cfg = model.cfg
    state = model.state_dict()
    names = list(state)
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    mgr = CheckpointManager(design)
    t0 = time.perf_counter()
    with PeakRss() as save_rss:
        sim_save = mgr.save(1, state)
    wall_save = time.perf_counter() - t0
    log(f"[{what}] {cfg.name} {cfg.num_layers} layers, {model.dtype}: "
        f"{nbytes} B in {len(names)} leaves, engine {mgr.fs.engine}, NVMM "
        f"{mgr.fs.stats()['nvmm_capacity_bytes']} B; save "
        f"{wall_save:.3f} s wall = {nbytes / wall_save / 1e9:.3f} GB/s, "
        f"{sim_save!r} s simulated; save's peak RSS {save_rss.gib:.2f} GiB")
    kept = {}
    if design == "log":
        g = torch.Generator(dev).manual_seed(seed + 7)
        for k in CKPT_EDIT:
            kept[k] = state[k].clone()
            state[k].add_(0.01 * torch.randn(
                state[k].shape, generator=g, device=dev).to(state[k].dtype))
        changed = {f"leaf{names.index(k)}" for k in CKPT_EDIT}
        t0 = time.perf_counter()
        sim_delta = mgr.save(2, state, changed=changed)
        log(f"[{what}] delta save of {sorted(changed)} = {CKPT_EDIT}, "
            f"edited on the card: {time.perf_counter() - t0:.3f} s wall, "
            f"{sim_delta!r} s simulated (the snapshot: {sim_save!r})")
    stats = mgr.fs.stats()
    mgr.crash()
    other = make_model(torch, cfg, model.dtype, dev, seed + 1)
    like = other.state_dict()
    sim0 = mgr.fs.simulated_time
    t0 = time.perf_counter()
    with PeakRss() as restore_rss:
        step, out = mgr.restore(like)
        torch.cuda.synchronize()
    wall_restore = time.perf_counter() - t0
    sim_restore = mgr.fs.simulated_time - sim0
    if step != (2 if design == "log" else 1):
        raise AssertionError(f"{what}: restored step {step}")
    bad = [k for k in names if out[k].device != like[k].device
           or not same_bits(torch, out[k], state[k])]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} tensors differ, e.g. "
                             f"{bad[:3]}")
    other.load_state_dict(out)
    del out, like
    log(f"[{what}] crash, recover and restore onto the card: "
        f"{wall_restore:.3f} s wall = {nbytes / wall_restore / 1e9:.3f} "
        f"GB/s, {sim_restore!r} s simulated; step {step}, all "
        f"{len(names)} tensors bit-equal on {dev}; restore's peak RSS "
        f"{restore_rss.gib:.2f} GiB")
    log(f"[{what}] fs stats before the crash: {stats}")
    want, counts = greedy_two(torch, dev, seed, model, what)
    got, more = greedy_two(torch, dev, seed, other, what)
    if got != want:
        raise AssertionError(f"{what}: restored tokens {got} != {want}")
    log(f"[{what}] the restored model serves the saved model's tokens "
        f"{got} ({counts['paged_attention_ragged']} + "
        f"{more['paged_attention_ragged']} paged_attention_ragged "
        f"launches)")
    for k, t in kept.items():
        state[k].copy_(t)
    del other, mgr, state, kept
    gc.collect()
    torch.cuda.empty_cache()
    return collections.Counter(counts) + collections.Counter(more)


# ------------------------------------------------------------ phases 32-34
def plain_attention(fn):
    """``fn()`` with the flash kernel's plain version as the attention past
    ``chunk_size`` (``attention.long_attention``), differentiated by
    autograd; no kernel launches."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import attention
    real = attention.long_attention
    attention.long_attention = flash_attention_ref
    try:
        return fn()
    finally:
        attention.long_attention = real


def card_ms(torch, fn, iters=3):
    """Mean CUDA-event ms of ``fn`` over ``iters`` calls after one warm
    call (host-paced)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def train(torch, dev, seed):
    """Phase 32: the training CLI on full-width InternLM2-1.8B, bf16 with
    fp32 masters and remat; returns every entry's launches of the run."""
    import math
    import repro_torch.kernels as ops
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_ref_backward)
    from repro_torch.launch import train as train_cli
    from repro_torch.models import LM, jax_leaf_ndims
    from repro_torch.training import adamw_update
    cfg = get_config(TRAIN_ARCH)
    argv = ["--device", str(dev), "--arch", TRAIN_ARCH, "--dtype",
            "bfloat16", "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(TRAIN_STEPS), "--seed", str(seed)]
    log(f"[train] python -m repro_torch.launch.train {' '.join(argv)}")
    report = {}
    ops.reset_launch_counts()
    train_cli.main(argv, report=report)
    torch.cuda.synchronize()
    counts = launch_counts(ops)
    want = cfg.num_layers * 2 * TRAIN_STEPS
    if counts["flash_attention"] != want or any(
            v for k, v in counts.items() if k != "flash_attention"):
        raise AssertionError(f"train: launches {counts}, want "
                             f"{want} flash_attention (layers x forward and "
                             f"remat recompute x steps)")
    losses = report["losses"]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train: losses {losses}")
    steps = report["step_s"]
    step_ms = 1e3 * sum(steps[1:]) / len(steps[1:])
    tok_s = report["tokens_per_step"] / (step_ms / 1e3)
    peak = report["peak_bytes"]
    log(f"[train] {cfg.name}: {cfg.param_count()} params (unpadded "
        f"vocab), losses {losses}; step 0 {steps[0] * 1e3:.1f} ms, then "
        f"{step_ms:.1f} ms a step = {tok_s:.1f} tokens/s; peak "
        f"{peak / 2**30:.2f} GiB; {counts['flash_attention']} "
        f"flash_attention launches")
    # the optimizer and the plain attention backward, each alone on the
    # card, against a step
    model, state = report["model"], report["state"]
    params = dict(model.named_parameters())
    decay = {n: d >= 2 for n, d in jax_leaf_ndims(model).items()}
    g = torch.Generator(dev).manual_seed(seed)
    grads = {n: (1e-3 * torch.randn(p.shape, generator=g, device=dev)).to(
        p.dtype) for n, p in params.items()}
    opt_ms = card_ms(torch, lambda: adamw_update(
        report["opt_cfg"], grads, state.opt_state, params, decay))
    del grads, model, state, params, report
    free(torch)
    B, S, H, Kh, D = (TRAIN_FLASH[k] for k in "B Sq H K D".split())
    q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
               for s in ((B, S, H, D), (B, S, Kh, D), (B, S, Kh, D)))
    dout = torch.randn((B, S, H, D), generator=g, device=dev).to(q.dtype)
    bwd_ms = card_ms(torch, lambda: flash_attention_ref_backward(
        q, k, v, dout, causal=True, scale=D ** -0.5))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    fn_ms = card_ms(torch, lambda: FlashAttentionFn.apply(
        qg, kg, vg, True, D ** -0.5).backward(dout))
    ops.reset_launch_counts()
    del q, k, v, dout, qg, kg, vg
    free(torch)
    log(f"[train] alone on the card: AdamW update {opt_ms:.1f} ms "
        f"({opt_ms / step_ms:.1%} of a step); plain attention backward "
        f"{bwd_ms:.2f} ms a layer x {cfg.num_layers} = "
        f"{bwd_ms * cfg.num_layers:.1f} ms "
        f"({bwd_ms * cfg.num_layers / step_ms:.1%} of a step); the "
        f"Function's forward + backward {fn_ms:.2f} ms a layer")
    # step 0's loss again, the same weights, the plain attention
    model = LM(cfg, dtype=torch.bfloat16, device=dev).init(
        torch.Generator(dev).manual_seed(seed))
    batch = SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                               seed=seed).batch(0)
    with torch.no_grad():
        plain = float(plain_attention(lambda: model.loss_fn(batch)[0]))
    del model
    free(torch)
    rel = abs(losses[0] - plain) / abs(plain)
    if not rel <= 1e-2:
        raise AssertionError(f"train: step 0 loss {losses[0]} on the kernel "
                             f"path, {plain} on the plain path")
    log(f"[train] step 0 loss {losses[0]!r} (kernel) vs {plain!r} (plain "
        f"attention): rel {rel:.3e} (tolerance 1e-2, bf16)")
    return counts, {"step_ms": step_ms, "first_step_ms": steps[0] * 1e3,
                    "tokens_per_s": tok_s, "peak_gib": peak / 2**30,
                    "optimizer_ms": opt_ms, "attn_backward_ms": bwd_ms,
                    "function_fwd_bwd_ms": fn_ms}


def loss_and_grads(model, batch):
    for p in model.parameters():
        p.grad = None
    loss, _ = model.loss_fn(batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return loss.detach().item(), grads


def parity_train(torch, dev, seed):
    """Phase 33: fp32 loss and gradients through #9 against the plain
    attention differentiated by autograd, same weights and batch; returns
    every entry's launches of the kernel-path runs."""
    import repro_torch.kernels as ops
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import LM
    total = collections.Counter()
    for arch, layers, S in PARITY_TRAIN:
        cfg = cut(get_config(arch), layers)
        what = f"parity-train {cfg.name} L={layers} S={S}"
        model = LM(cfg, device=dev).init(
            torch.Generator(dev).manual_seed(seed))
        model.requires_grad_(True)
        batch = SyntheticLMDataset(cfg.vocab_size, S, 1,
                                   seed=seed).batch(0)
        ops.reset_launch_counts()
        loss, grads = loss_and_grads(model, batch)
        torch.cuda.synchronize()
        counts = launch_counts(ops)
        if counts["flash_attention"] != 2 * layers or any(
                v for k, v in counts.items() if k != "flash_attention"):
            raise AssertionError(f"{what}: launches {counts}")
        total.update(counts)
        ref_loss, ref = plain_attention(lambda: loss_and_grads(model, batch))
        rel = abs(loss - ref_loss) / abs(ref_loss)
        worst, worst_leaf = 0.0, None
        for n, gk in grads.items():
            r = float((gk - ref[n]).abs().max()) / max(
                float(ref[n].abs().max()), 1e-30)
            if r > worst:
                worst, worst_leaf = r, n
        log(f"[{what}] loss {loss!r} (kernel) vs {ref_loss!r} (plain): rel "
            f"{rel:.3e} (tolerance 1e-5); worst gradient leaf {worst_leaf}: "
            f"max |diff| = {worst:.3e} x its max |g| (tolerance 1e-3); "
            f"{counts['flash_attention']} flash_attention launches")
        if not (rel <= 1e-5 and worst <= 1e-3):
            raise AssertionError(f"{what}: loss rel {rel}, worst leaf "
                                 f"{worst_leaf} {worst}")
        del model, grads, ref
        free(torch)
    return total


def train_crash(torch, dev, seed):
    """Phase 34: the training example in its own process on the card (its
    deterministic algorithms need ``CUBLAS_WORKSPACE_CONFIG`` before the
    process's first cuBLAS call), its crash and resume checked by its
    ``--verify``; returns its result."""
    import os
    argv = [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"),
            "--device", str(dev), "--steps", str(CRASH_STEPS), "--crash-at",
            str(CRASH_AT), "--deterministic", "--verify", *CRASH_ARGS]
    log(f"[train-crash] {' '.join(argv[1:])} (the example's 200 steps cut "
        f"to {CRASH_STEPS} to fit the time limit)")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                          timeout=420, cwd=str(ROOT))
    for line in proc.stdout.splitlines()[:-1]:
        log(f"[train-crash] {line}")
    if proc.returncode != 0:
        raise AssertionError(f"train-crash: exit {proc.returncode}\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])["resume"]
    rs = res["restore"]
    replayed = res["replayed_steps"]
    back = CRASH_AT // 10 * 10
    if rs["step"] != back or not rs["bit_equal"] or not res[
            "replay_bit_equal"] or replayed != list(range(back + 1,
                                                          CRASH_AT + 1)):
        raise AssertionError(f"train-crash: {res}")
    saves = ", ".join(f"step {s['step']} {s['wall_s']:.3f} s wall "
                      f"({s['sim_s']!r} s simulated)" for s in res["saves"])
    log(f"[train-crash] saves: {saves}; restore to step {rs['step']}: "
        f"{rs['wall_s']:.3f} s wall ({rs['sim_s']!r} s simulated), all "
        f"{rs['leaves']} leaves bit-equal to the step-{rs['step']} state; "
        f"steps {replayed[0]}-{replayed[-1]} replayed with the first run's "
        f"losses bit for bit ({[res['losses'][str(s)] for s in replayed]}); "
        f"peak RSS {res['peak_rss_gib']:.2f} GiB; {res['wall_s']:.1f} s "
        f"training wall")
    return res


# ------------------------------------------------------------ phases 35-38
def dryrun_phase(torch, dev):
    """Phase 35: the dry run's cells on fake CUDA tensors over fake
    256/512-rank worlds; returns the artifacts."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    total = torch.cuda.get_device_properties(0).total_memory
    if not 0.9 * H100.hbm_bytes <= total <= 1.1 * H100.hbm_bytes:
        raise AssertionError(f"dryrun: the H100 record's {H100.hbm_bytes} "
                             f"HBM bytes against the card's {total}")
    log(f"[dryrun] H100 record: {H100.hbm_bytes / 1e9:.1f} GB HBM, the "
        f"card's total_memory {total / 1e9:.2f} GB")
    out_dir = ROOT / "build" / "dryrun"
    arts = []
    # the pod cells before the multipod one: one fake world a mesh size
    # (torch 2.11 resolves the groups of a world started again by the
    # names of the destroyed one's)
    for arch, shape, multi, layers in sorted(DRYRUN_CELLS + DRYRUN_SETTLED,
                                             key=lambda c: c[2]):
        t0 = time.time()
        r = dryrun.run_cell(arch, shape, multi, out_dir,
                            layers_override=layers, device=dev.type)
        secs = time.time() - t0
        c = r["collectives"]
        if not (r["per_device_live_bytes"] > r["memory"]["argument_bytes"]
                > 0 and r["cost"]["flops"] > 0 and c["num_ops"] > 0
                and r["partial_guard_fires"] == 0):
            raise AssertionError(f"dryrun {arch} {shape}: {r}")
        if get_config(arch).moe is not None \
                and not c.get("all-gather", {}).get("count"):
            raise AssertionError(f"dryrun {arch}: no expert all-gather")
        kinds = ", ".join(f"{k} {v['count']} ({v['wire_bytes'] / 1e9:.3f} GB)"
                          for k, v in c.items() if isinstance(v, dict))
        log(f"[dryrun] {arch} x {shape} x {r['mesh']} "
            f"({r['devices']} ranks{f', {layers} layers' if layers else ''}"
            f", mb {r.get('microbatches', 1)}): live "
            f"{r['per_device_live_bytes'] / 1e9:.2f} GB (arguments "
            f"{r['memory']['argument_bytes'] / 1e9:.3f} GB) fits_hbm "
            f"{r['fits_hbm']}; {c['num_ops']} collectives, "
            f"{c['total_wire_bytes'] / 1e9:.3f} GB wire: {kinds}; flops "
            f"{r['cost']['flops']:.4e}, bytes accessed "
            f"{r['cost']['bytes accessed']:.4e}; {secs:.1f} s")
        arts.append(r)
    dist.destroy_process_group()
    return arts


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def card_world(torch, dev):
    """``nccl`` world of one rank on ``dev`` and its (1, 1) mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1,
                            device_id=dev)
    return make_test_mesh((1, 1), device_type="cuda")


def same_or_close(torch, what, got, want):
    """'bit for bit' when ``got`` equals ``want`` exactly, else raises
    unless they agree within the fp32 tolerance, and says so."""
    got, want = got.float(), want.float()
    if torch.equal(got, want):
        return "bit for bit"
    atol, rtol = TOL["float32"]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol, msg=what)
    return (f"within fp32 tolerance (max abs diff "
            f"{float((got - want).abs().max()):.3e})")


def dryrun_card(torch, dev, seed):
    """Phase 36: the (1, 1) mesh's real train step and prefill on DTensor
    weights against plain tensors, and the dry run's predictions of the
    same cut cells; returns #9's launches of the DTensor runs."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    import repro_torch.kernels as ops
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.distributed.sharding import batch_specs, param_specs
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import (abstract_state, install_params,
                                          state_specs, with_shardings)
    from repro_torch.models import LM
    from repro_torch.training import AdamWConfig, make_train_step
    cfg = cut(get_config(CARD_ARCH), CARD_LAYERS)
    pred = {shape: dryrun.run_cell(
        CARD_ARCH, shape, False, ROOT / "build" / "dryrun",
        layers_override=CARD_LAYERS, device=dev.type, batch_override=b,
        mesh_shape=((1, 1), ("data", "model")))
        for shape, b in CARD_BATCH.items()}
    dist.destroy_process_group()
    mesh = card_world(torch, dev)
    launches = 0
    try:
        def model_of(remat):
            return LM(cfg, dtype=torch.bfloat16, device=dev,
                      remat=remat).init(torch.Generator(dev).manual_seed(seed))

        def as_dtensors(model, train):
            if train:
                state = abstract_state(model)
                state = with_shardings(state, state_specs(state, model, mesh),
                                       mesh)
                state["params"] = install_params(model, state.params, True)
                return state
            params = with_shardings(dict(model.named_parameters()),
                                    param_specs(model, mesh), mesh)
            return install_params(model, params, False)

        B = CARD_BATCH["train_4k"]
        data = SyntheticLMDataset(cfg.vocab_size, 4096, B,
                                  seed=seed).batch(0)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
        results = {}
        for shape in CARD_BATCH:
            for kind in ("dtensor", "plain"):
                model = model_of(shape == "train_4k")
                if shape == "train_4k":
                    if kind == "dtensor":
                        state = as_dtensors(model, True)
                        inp = with_shardings(batch, batch_specs(batch, mesh),
                                             mesh)
                    else:
                        model.requires_grad_(True)
                        state = abstract_state(model)
                        inp = batch
                    step = make_train_step(model, AdamWConfig())
                    run = lambda: step(state, inp)[1]["loss"]
                else:
                    toks = torch.randint(
                        0, cfg.vocab_size, (CARD_BATCH[shape], 32768),
                        generator=torch.Generator(dev).manual_seed(seed),
                        device=dev, dtype=torch.int32)
                    if kind == "dtensor":
                        as_dtensors(model, False)
                        toks = with_shardings(toks, batch_specs(
                            {"t": toks}, mesh)["t"], mesh)
                    run = lambda: model.prefill(toks, 32768)[0]
                free(torch)
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launch_counts()
                # FlopCounterMode counts a DTensor run at global shapes and
                # again at local ones: the plain run's count is the one read
                fc = FlopCounterMode(display=False)
                with implicit_replication(), (
                        fc if kind == "plain" else contextlib.nullcontext()):
                    out = run()
                torch.cuda.synchronize()
                counts = launch_counts(ops)
                if counts["flash_attention"] != CARD_LAYERS * (
                        2 if shape == "train_4k" else 1) or any(
                        v for k, v in counts.items()
                        if k != "flash_attention"):
                    raise AssertionError(f"dryrun-card {shape} {kind}: "
                                         f"launches {counts}")
                if kind == "dtensor":
                    launches += counts["flash_attention"]
                    out = out.full_tensor()
                results[shape, kind] = (out.detach(), fc.get_total_flops(),
                                        torch.cuda.max_memory_allocated())
                # the train step's closure holds its model: dropped with it,
                # or the plain train model stays live through prefill
                del model, run, out
                step = state = inp = None
                free(torch)
            (got, _, peak), (want, flops, _) = (results[shape, "dtensor"],
                                                 results[shape, "plain"])
            how = same_or_close(torch, f"dryrun-card {shape}", got, want)
            p = pred[shape]
            ratio = peak / p["per_device_live_bytes"]
            what = "loss" if shape == "train_4k" else "last logits"
            log(f"[dryrun-card] {cfg.name} {CARD_LAYERS} layers bf16, "
                f"{shape} at batch {CARD_BATCH[shape]} on the (1, 1) mesh: "
                f"{what} on DTensor weights {how} to the plain tensors' "
                f"({float(want.flatten()[0])!r}); peak "
                f"{peak / 2**30:.3f} GiB (max_memory_allocated) against the "
                f"dry run's {p['per_device_live_bytes'] / 2**30:.3f} GiB "
                f"predicted ({ratio:.3f}x, band {CARD_PEAK_BAND}; arguments "
                f"{p['memory']['argument_bytes'] / 2**30:.3f} GiB); flops "
                f"{flops:.4e} (FlopCounterMode, plain run) against "
                f"{p['cost']['flops']:.4e} predicted; "
                f"{CARD_LAYERS * (2 if shape == 'train_4k' else 1)} "
                f"flash_attention launches")
            lo, hi = CARD_PEAK_BAND
            if not lo <= ratio <= hi:
                raise AssertionError(
                    f"dryrun-card {shape}: measured peak / predicted live "
                    f"{ratio:.3f} outside {CARD_PEAK_BAND}")
    finally:
        dist.destroy_process_group()
    return launches


def ep_card(torch, dev, seed):
    """Phase 37: one DeepSeek-V2 MoE layer on the (1, 1) mesh, each EP
    path through ``apply_moe`` on DTensors against the single-device
    ``apply_moe`` on plain tensors."""
    import torch.distributed as dist
    from types import SimpleNamespace

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import P, distribute
    from repro_torch.models import blocks as B
    from repro_torch.models.moe import apply_moe
    mesh = card_world(torch, dev)
    try:
        base = get_config(EP_ARCH)
        blk = B.DecoderBlock(base, torch.bfloat16, dev, "moe")
        blk.init_weights(torch.Generator(dev).manual_seed(seed))
        m = base.moe
        specs = {"router": P(None, None),
                 "experts.w_gate": P("model", None, "data"),
                 "experts.w_up": P("model", None, "data"),
                 "experts.w_down": P("model", "data", None),
                 "shared.w_gate": P(None, "model"),
                 "shared.w_up": P(None, "model"),
                 "shared.w_down": P("model", None)}
        d = distribute({n: blk.get_parameter(n).detach() for n in specs},
                       specs, mesh)
        dt = SimpleNamespace(
            router=d["router"], ffn_kind="moe",
            experts=SimpleNamespace(**{n: d["experts." + n] for n in
                                       ("w_gate", "w_up", "w_down")}),
            shared=SimpleNamespace(**{n: d["shared." + n] for n in
                                      ("w_gate", "w_up", "w_down")}))
        for path, tokens, cf in EP_CASES:
            cfg = dataclasses.replace(base, moe=dataclasses.replace(
                m, capacity_factor=cf or float(m.num_experts)))
            shape = (1, tokens) if tokens > 4096 else (tokens, 1)
            x = torch.randn(shape + (base.d_model,), device=dev,
                            generator=torch.Generator(dev).manual_seed(seed)
                            ).to(torch.bfloat16)
            xd = distribute({"x": x}, {"x": P("data", None, None)},
                            mesh)["x"]

            def ep():
                with implicit_replication():
                    return apply_moe(dt, cfg, xd, ("data",))

            def plain():
                return apply_moe(blk, cfg, x)
            with torch.no_grad():
                (y, aux), (y0, aux0) = ep(), plain()
                how = same_or_close(torch, path, y.full_tensor(), y0)
                how_aux = same_or_close(torch, path + " aux",
                                        aux.full_tensor(), aux0)
                ep_ms, plain_ms = (card_ms(torch, f) for f in (ep, plain))
            log(f"[ep-card] {path}: {tokens} tokens, capacity factor "
                f"{cfg.moe.capacity_factor} "
                f"({'no-drop' if cf is None else 'published'}), "
                f"{m.num_experts} experts x (d {base.d_model}, hidden "
                f"{m.d_expert}), {m.num_shared_experts} shared, bf16: "
                f"output {how}, aux {how_aux} to the single-device "
                f"apply_moe; {ep_ms:.3f} ms through the EP path on the "
                f"(1, 1) mesh, {plain_ms:.3f} ms single-device "
                f"(host-paced CUDA events)")
            del x, xd, y, y0
            free(torch)
        del blk, d, dt
        free(torch)
    finally:
        dist.destroy_process_group()


def examples_phase(torch, dev):
    """Phase 38: the serving example's twin on the card in its own
    process; its asserts are the gate."""
    import os
    argv = [sys.executable, str(ROOT / "examples" /
                                "serve_kv_offload_torch.py")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.time()
    proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                          timeout=300, cwd=str(ROOT))
    for line in proc.stdout.splitlines():
        log(f"[examples] {line}")
    if proc.returncode != 0:
        raise AssertionError(f"examples: exit {proc.returncode}\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    log(f"[examples] examples/serve_kv_offload_torch.py passed its asserts "
        f"on the card in {time.time() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repo (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    import repro_torch.kernels as ops
    from repro_torch.configs import get_config
    dev = torch.device("cuda", 0)
    t0 = time.time()

    def stamp(phase):
        log(f"[time] {phase} done at {time.time() - t0:.1f} s")

    phase_env(torch)
    rows = phase_kernels(torch, dev, args.seed)
    stamp("kernels")

    # every entry's launches over the serving phases, each read just
    # after its run
    served = collections.Counter()
    dense = get_config("internlm2-1.8b")
    model = make_model(torch, dense, torch.bfloat16, dev, args.seed)
    rows["paged_attention_ragged"]["launches"], bf16_pages, counts = serve(
        torch, dev, args.seed, "serve", model, ops.paged_attention_ragged)
    rows[WRITE].update(launches=counts[WRITE], path="serve")
    served.update(counts)
    del model
    free(torch)
    stamp("serve")
    model4, ref4 = parity(torch, dev, args.seed, "parity", dense)
    stamp("parity")
    counts = unfused(torch, dev, args.seed, "unfused", model4, ref4,
                     ops.paged_attention, ops.paged_attention_ragged)
    rows["paged_attention"]["launches"] = counts["paged_attention"]
    served.update(counts)
    del model4
    free(torch)
    stamp("unfused")

    model = make_model(torch, dense, torch.bfloat16, dev, args.seed, "int8")
    row = rows["paged_attention_ragged_q8"]
    row["launches"], int8_pages, counts = serve(
        torch, dev, args.seed, "serve-int8", model,
        ops.paged_attention_ragged_q8)
    served.update(counts)
    # the pages a byte budget buys follow the page bytes: within a page of
    # bf16 pages x (bf16 page bytes / int8 page bytes)
    g8 = model.cache_descriptor(16).page_group_bytes
    g16 = dense.num_layers * 16 * 2 * dense.num_kv_heads * dense.head_dim * 2
    if int8_pages != (1 << 30) // g8 \
            or abs(int8_pages - bf16_pages * g16 / g8) > 1:
        raise AssertionError(f"serve-int8: {int8_pages} int8 pages against "
                             f"{bf16_pages} bf16 pages at 1 GiB")
    log(f"[serve-int8] int8/bf16 pool pages at 1 GiB: {int8_pages}/"
        f"{bf16_pages} = {int8_pages / bf16_pages:.4f} (page bytes "
        f"{g8}/{g16})")
    row["pool_pages"] = {"int8": int8_pages, "bfloat16": bf16_pages}
    del model
    free(torch)
    stamp("serve-int8")
    model4, ref4 = parity(torch, dev, args.seed, "parity-int8", dense,
                          kv_cache_dtype="int8", first=CHUNK)
    counts = unfused(torch, dev, args.seed, "unfused-int8", model4, ref4,
                     ops.paged_attention_q8, ops.paged_attention_ragged_q8,
                     first=CHUNK)
    row["decode_launches"] = counts["paged_attention_q8"]
    served.update(counts)
    del model4
    free(torch)
    stamp("parity-int8")

    mla = get_config("deepseek-v2-236b-noexperts")
    model = make_model(torch, mla, torch.bfloat16, dev, args.seed)
    row = rows["mla_paged_attention_ragged"]
    row["launches"], _, counts = serve(torch, dev, args.seed, "serve-mla",
                                       model, ops.mla_paged_attention_ragged)
    served.update(counts)
    del model
    free(torch)
    stamp("serve-mla")
    model4, ref4 = parity(torch, dev, args.seed, "parity-mla", mla,
                          full_width_check=False)
    counts = unfused(torch, dev, args.seed, "unfused-mla", model4, ref4,
                     ops.mla_paged_attention, ops.mla_paged_attention_ragged)
    row["decode_launches"] = counts["mla_paged_attention"]
    served.update(counts)
    del model4
    free(torch)
    stamp("parity-mla")

    # speculative decode: decode rows at Qmax 8 through #1, #5 and #7
    model = make_model(torch, dense, torch.bfloat16, dev, args.seed)
    counts, q8 = serve_spec(torch, dev, args.seed, model)
    rows["paged_attention_ragged"]["qmax8_launches"] = {"serve-spec": q8}
    served.update(counts)
    del model
    free(torch)
    stamp("serve-spec")
    for what, cfg, kd, entry, first in (
            ("parity-spec", dense, "native", ops.paged_attention_ragged,
             None),
            ("parity-spec-int8", dense, "int8",
             ops.paged_attention_ragged_q8, CHUNK),
            ("parity-spec-mla", mla, "native",
             ops.mla_paged_attention_ragged, None)):
        counts, q8 = parity_spec(torch, dev, args.seed, what, cfg, entry,
                                 kv_cache_dtype=kd, first=first)
        rows[entry.__name__].setdefault("qmax8_launches", {})[what] = q8
        served.update(counts)
    stamp("parity-spec")
    model = make_model(torch, dense, torch.bfloat16, dev, args.seed)
    served.update(serve_prefix(torch, dev, args.seed, model))
    del model
    free(torch)
    served.update(prefix_parity(torch, dev, args.seed, dense))
    stamp("serve-prefix")
    served.update(crash_recover(torch, dev, args.seed, dense))
    stamp("crash-recover")

    model = make_model(torch, dense, torch.bfloat16, dev, args.seed)
    counts = serve_long(torch, dev, args.seed, model)
    rows["flash_attention"]["launches"] = counts["flash_attention"]
    rows["flash_attention"]["path"] = "serve-long"
    rows["paged_attention_ragged"]["long_prompt_launches"] = counts[
        "paged_attention_ragged"]
    served.update(counts)
    del model
    free(torch)
    stamp("serve-long")
    served.update(parity_long(torch, dev, args.seed, dense))
    stamp("parity-long")

    # the dense mirror: no kernel on its path, each phase read alone
    model = make_model(torch, dense, torch.bfloat16, dev, args.seed)
    for kv_engine in ("log", "kvhybrid", "paged"):
        what = {"paged": "serve-paged-mirror"}.get(kv_engine,
                                                   f"serve-{kv_engine}")
        served.update(serve_mirror(torch, dev, args.seed, what, model,
                                   kv_engine))
        stamp(what)
    del model
    free(torch)
    served.update(parity_mirror(torch, dev, args.seed, dense, mla))
    stamp("parity-mirror")

    # the MoE family and the other dense configs at published widths
    served.update(serve_families(torch, dev, args.seed, rows))
    stamp("serve-families")
    served.update(parity_families(torch, dev, args.seed))
    stamp("parity-families")

    # the state-space families: Mamba-2 on pooled state rows, Zamba2 on
    # the mirror with #9 at its shared-attention shape
    served.update(serve_mamba2(torch, dev, args.seed))
    stamp("serve-mamba2")
    counts = serve_zamba2(torch, dev, args.seed)
    rows["flash_attention"]["zamba2_launches"] = counts["flash_attention"]
    served.update(counts)
    stamp("serve-zamba2")
    served.update(parity_ssm(torch, dev, args.seed))
    stamp("parity-ssm")
    served.update(parity_hybrid(torch, dev, args.seed))
    stamp("parity-hybrid")

    # MLA prefill past chunk_size: #9 at (192, 128), then #7
    model = make_model(torch, mla, torch.bfloat16, dev, args.seed)
    counts = serve_long(torch, dev, args.seed, model, "serve-mla-long",
                        "mla_paged_attention_ragged")
    rows["flash_attention"]["mla_long_launches"] = counts["flash_attention"]
    rows["mla_paged_attention_ragged"]["long_prompt_launches"] = counts[
        "mla_paged_attention_ragged"]
    served.update(counts)
    del model
    free(torch)
    stamp("serve-mla-long")
    served.update(parity_long(torch, dev, args.seed, cut(mla, 4),
                              "parity-mla-long",
                              "mla_paged_attention_ragged"))
    stamp("parity-mla-long")
    # the encoder-decoder and the VLM at model level: #9 non-causal over
    # the encoder's frames and in cross-attention, causal over the image
    for what, arch, prompts, key in (
            ("model-encdec", "seamless-m4t-large-v2", ENCDEC_PROMPTS,
             "encdec_launches"),
            ("model-vlm", "llava-next-mistral-7b", VLM_PROMPTS,
             "vlm_launches")):
        counts = model_frontend(torch, dev, args.seed, what, arch, prompts)
        rows["flash_attention"][key] = counts["flash_attention"]
        served.update(counts)
        stamp(what)
    for what, arch, prompts in (
            ("parity-encdec", "seamless-m4t-large-v2", ENCDEC_PROMPTS),
            ("parity-vlm", "llava-next-mistral-7b", VLM_PROMPTS)):
        served.update(parity_frontend(torch, dev, args.seed, what, arch,
                                      prompts))
        stamp(what)

    # the file-system tier: the paper's fio grid on the port's NVCacheFS
    # (host code), then the card's weights checkpointed through each design
    fs_matrix()
    stamp("fs-matrix")
    model = make_model(torch, dense, torch.bfloat16, dev, args.seed)
    for design in CKPT_DESIGNS:
        served.update(ckpt(torch, dev, args.seed, design, model))
        stamp(f"ckpt-{design}")
    del model
    free(torch)

    # training: the CLI at full width (#9 forward under its autograd
    # Function), fp32 parity of loss and gradients, the example's crash
    counts, rows["flash_attention"]["train"] = train(torch, dev, args.seed)
    rows["flash_attention"]["train_launches"] = counts["flash_attention"]
    stamp("train")
    counts = parity_train(torch, dev, args.seed)
    rows["flash_attention"]["parity_train_launches"] = counts[
        "flash_attention"]
    stamp("parity-train")
    train_crash(torch, dev, args.seed)
    stamp("train-crash")

    # distribution: the dry run on fake 256/512-rank worlds, then real
    # DTensors on a one-card mesh (#9 through its custom op, the EP paths)
    dryrun_phase(torch, dev)
    stamp("dryrun")
    rows["flash_attention"]["dryrun_card_launches"] = dryrun_card(
        torch, dev, args.seed)
    stamp("dryrun-card")
    ep_card(torch, dev, args.seed)
    stamp("ep-card")
    examples_phase(torch, dev)
    stamp("examples")

    for name, row in rows.items():
        row["serving_launches"] = served[name]
        if row.get("path") == "public entry" and served[name]:
            raise AssertionError(f"{name}: a serving phase launched it "
                                 f"{served[name]} times")
    log(f"[launches] over the serving phases: {dict(served)}")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    if any(r["route"] not in ("cuda", "triton") for r in rows.values()):
        raise AssertionError("a row's route is neither cuda nor triton")
    print(smi_line())
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys},
         **{k: v for k, v in r.items() if k not in keys}}
        for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
