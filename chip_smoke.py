#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero, with
no result line, without them or outside a checkout of the repo. Phases —
each raises on failure, and any failure ends the run with a traceback:

1. env        — torch/CUDA/nvcc versions and the card; builds every
                kernel source (one ``nvcc`` per source, all started
                together).
2. kernels    — each kernel at the main paths' shapes in its working
                dtypes, held against its plain PyTorch version (a bf16
                output also against the plain fp32 version on the same
                inputs, to half a bf16 ulp), the bitwise pins (padding
                slots and q_len=0 rows are 0, dead slots change nothing,
                ragged at q_len=1 is the decode entry), and CUDA-event
                times beside the bound and a library call. Dense and int8:
                B=8, H=16, K=8, D=128, T=16, MP=64, Qmax 128 and 1; MLA:
                B=8, H=128, dc=512, dr=64, T=16, MP=64, Qmax 128 (the MLA
                serve phase's prefill chunk) and 1.
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

Each serving path is driven with the launch counts set to 0 just before
it and read just after. The last lines are the card's name and power
limit, a ``{"kernels": ...}`` JSON line, and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and flop/s for
# each operand type — bf16 on the tensor cores (exact products, fp32
# accumulation), fp32 outside them
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# kernel vs its plain version on the same inputs (tests/test_kernels.py)
TOL = {"float32": (1e-4, 4e-5), "bfloat16": (1e-1, 4e-2)}
# bf16 kernel output vs the plain fp32 version on the same values: the
# kernel's math is fp32, so only the output's rounding to bf16 (at most
# half an ulp, 2^-8 relative) may differ. Accumulating in bf16, or
# dropping part of a row, fails this.
TOL_BF16_VS_FP32 = (1e-5, 2 ** -8)
KERNEL_PY = "src/repro/kernels/paged_attention/kernel.py"
CSRC = "src/repro_torch/kernels/paged_attention/csrc/"
# row name → (TPU kernel's pallas_call line, CUDA source)
KERNELS = {
    "paged_attention_ragged": (f"{KERNEL_PY}:321", CSRC + "paged_attention.cu"),
    "paged_attention": (f"{KERNEL_PY}:126", CSRC + "paged_attention.cu"),
    "paged_attention_ragged_q8": (f"{KERNEL_PY}:481",
                                  CSRC + "paged_attention.cu"),
    "mla_paged_attention_ragged": (f"{KERNEL_PY}:637",
                                   CSRC + "mla_paged_attention.cu"),
}
GEOM = dict(B=8, H=16, K=8, D=128, T=16, MP=64)
MLA_GEOM = dict(B=8, H=128, dc=512, dr=64, T=16, MP=64)
CHUNK = 128                  # serve phases' prefill chunk = kernel Qmax


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
        regs = [ln.split("ptxas info    :")[-1].strip()
                for ln in text.splitlines() if "Used" in ln]
        spills = [ln.strip() for ln in text.splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        log(f"[env] built {src.relative_to(ROOT)}: {len(regs)} kernels; "
            f"{regs[:3]}; spilling: {spills[:3]}")
    log(f"[env] kernel build {time.time() - t0:.1f} s")


# --------------------------------------------------------------- phase 2
def cuda_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    plain calls, the plain fp32 version's arguments, a copy of the
    arguments with every dead slot poisoned, the decode entry its q_len=1
    slice must equal, the work it must do, and a library yardstick."""


def dense_case(torch, dev, dtype, qmax, seed, q8=False):
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.models.attention import quantize_kv
    B, H, K, D, T, MP = (GEOM[k] for k in "B H K D T MP".split())
    P = B * MP + 64
    g = torch.Generator(dev).manual_seed(seed)
    lengths, q_lens = row_lengths(torch, dev, qmax)
    table = block_table(torch, g, dev, B, MP, P, T, lengths)
    q = torch.randn((B, qmax, H, D), generator=g, device=dev).to(dtype)
    pk = torch.randn((P, T, K, D), generator=g, device=dev)
    pv = torch.randn((P, T, K, D), generator=g, device=dev)
    dead = dead_slots(torch, P, T, table, lengths)
    c = Case()
    if q8:
        (pk, ks), (pv, vs) = quantize_kv(pk), quantize_kv(pv)
        planes = (pk, pv, ks, vs)
        poisoned = tuple(x.clone() for x in planes)
        poisoned[0][dead], poisoned[1][dead] = 127, -127
        poisoned[2][dead], poisoned[3][dead] = 1e6, 1e6
        ragged, decode = ops.paged_attention_ragged_q8, ops.paged_attention_q8
        plain_r, plain_d = (ref.paged_attention_ragged_q8_ref,
                            ref.paged_attention_q8_ref)
        # SDPA over K/V gathered and dequantized beforehand
        kd = gather(ref.dequant_pool(pk, ks).to(dtype), table)
        vd = gather(ref.dequant_pool(pv, vs).to(dtype), table)
        page_bytes = T * K * (2 * D + 2 * 2)
    else:
        pk, pv = pk.to(dtype), pv.to(dtype)
        planes = (pk, pv)
        poisoned = (pk.clone(), pv.clone())
        poisoned[0][dead], poisoned[1][dead] = 1e4, -1e4
        ragged, decode = ops.paged_attention_ragged, ops.paged_attention
        plain_r, plain_d = ref.paged_attention_ragged_ref, ref.paged_attention_ref
        kd, vd = gather(pk, table), gather(pv, table)
        page_bytes = T * K * D * 2 * q.element_size()
    rows = (table, lengths)
    if qmax == 1:
        c.kern = lambda *a: decode(a[0][:, 0], *a[1:-1])[:, None]
        c.plain = lambda *a: plain_d(a[0][:, 0], *a[1:-1])[:, None]
    else:
        c.kern = lambda *a: ragged(*a)
        c.plain = lambda *a: plain_r(*a)
    c.args = (q,) + planes + rows + (q_lens,)
    c.args32 = (q.float(),) + c.args[1:]
    c.poisoned = (q,) + poisoned + rows + (q_lens,)
    c.decode = lambda: decode(q[:, 0], *planes, *rows)[:, None]
    c.library = sdpa(torch, q, kd, vd, lengths, q_lens)
    c.q_lens, c.out_dtype = q_lens, dtype
    c.rate_dtype = str(dtype).split(".")[-1]
    nbytes, flops = 0, 0
    for n, ql in zip(lengths.tolist(), q_lens.tolist()):
        if ql > 0:
            nbytes += -(-n // T) * page_bytes
            flops += sum(4 * D * (n - ql + i + 1) for i in range(ql)) * H
    nbytes += 2 * q.numel() * q.element_size() + table.numel() * 4 + 2 * B * 4
    c.work = (nbytes, flops)
    return c


def mla_case(torch, dev, pool_dtype, qmax, seed):
    from repro_torch.kernels.paged_attention import ops, ref
    B, H, dc, dr, T, MP = (MLA_GEOM[k] for k in "B H dc dr T MP".split())
    P = B * MP + 64
    scale = 1.0 / (128 + 64) ** 0.5            # 1/sqrt(qk_nope + qk_rope)
    g = torch.Generator(dev).manual_seed(seed)
    lengths, q_lens = row_lengths(torch, dev, qmax)
    table = block_table(torch, g, dev, B, MP, P, T, lengths)
    q_c = torch.randn((B, qmax, H, dc), generator=g, device=dev)
    q_r = torch.randn((B, qmax, H, dr), generator=g, device=dev)
    pc = torch.randn((P, T, dc), generator=g, device=dev).to(pool_dtype)
    pkr = torch.randn((P, T, dr), generator=g, device=dev).to(pool_dtype)
    dead = dead_slots(torch, P, T, table, lengths)
    pc2, pkr2 = pc.clone(), pkr.clone()
    pc2[dead], pkr2[dead] = 1e4, -1e4
    c = Case()
    if qmax == 1:
        c.kern = lambda *a: ops.mla_paged_attention(
            a[0][:, 0], a[1][:, 0], *a[2:-1], scale=scale)[:, None]
        c.plain = lambda *a: ref.mla_paged_attention_ref(
            a[0][:, 0], a[1][:, 0], *a[2:-1], scale=scale)[:, None]
    else:
        c.kern = lambda *a: ops.mla_paged_attention_ragged(*a, scale=scale)
        c.plain = lambda *a: ref.mla_paged_attention_ragged_ref(
            *a, scale=scale)
    rows = (table, lengths, q_lens)
    c.args = (q_c, q_r, pc, pkr) + rows
    c.args32 = (q_c, q_r, pc.float(), pkr.float()) + rows
    c.poisoned = (q_c, q_r, pc2, pkr2) + rows
    c.decode = lambda: ops.mla_paged_attention(
        q_c[:, 0], q_r[:, 0], pc, pkr, table, lengths, scale=scale)[:, None]
    # SDPA: one KV head holding [c, kr], values c, gathered beforehand
    kc = gather(pc, table).float()
    k = torch.cat([kc, gather(pkr, table).float()], dim=-1)[:, :, None]
    c.library = sdpa(torch, torch.cat([q_c, q_r], dim=-1), k, kc[:, :, None],
                     lengths, q_lens, scale=scale)
    c.q_lens, c.out_dtype, c.rate_dtype = q_lens, torch.float32, "float32"
    nbytes, flops = 0, 0
    for n, ql in zip(lengths.tolist(), q_lens.tolist()):
        if ql > 0:
            nbytes += -(-n // T) * T * (dc + dr) * pc.element_size()
            flops += sum((2 * (dc + dr) + 2 * dc) * (n - ql + i + 1)
                         for i in range(ql)) * H
    nbytes += (q_c.numel() * 2 + q_r.numel()) * 4 + table.numel() * 4 \
        + 2 * B * 4
    c.work = (nbytes, flops)
    return c


def measure(torch, name, c, what):
    """Hold a case against its plain version and pins; time it. Returns
    the row fields of this case."""
    out, ref = c.kern(*c.args), c.plain(*c.args)
    torch.cuda.synchronize()
    tol = "bfloat16" if c.out_dtype == torch.bfloat16 else "float32"
    atol, rtol = TOL[tol]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    err = float((out.float() - ref.float()).abs().max())
    fields = {"max_abs_err": err}
    # the plain fp32 version on the same values: a bf16 output within half
    # an ulp, an fp32 output (MLA over a bf16 pool) within fp32 tolerance
    ref32 = c.plain(*c.args32).float()
    a32, r32 = TOL_BF16_VS_FP32 if tol == "bfloat16" else TOL["float32"]
    torch.testing.assert_close(out.float(), ref32, atol=a32, rtol=r32)
    fields["max_abs_err_vs_fp32"] = float((out.float() - ref32).abs().max())
    for b, ql in enumerate(c.q_lens.tolist()):
        if not bool((out[b, ql:] == 0).all()):
            raise AssertionError(f"{name} {what}: row {b} padding not 0")
    if not torch.equal(c.kern(*c.poisoned), out):
        raise AssertionError(f"{name} {what}: dead slots changed the output")
    ones = (c.q_lens == 1).nonzero().flatten()
    if not torch.equal(out[ones, 0], c.decode()[ones, 0]):
        raise AssertionError(f"{name} {what}: ragged at q_len=1 != decode")
    nbytes, flops = c.work
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FLOPS_PER_S[c.rate_dtype]
    bound = max(t_bytes, t_ops)
    ms = cuda_ms(torch, lambda: c.kern(*c.args), 20)
    plain_ms = cuda_ms(torch, lambda: c.plain(*c.args), 3)
    lib_ms = cuda_ms(torch, c.library, 10)
    log(f"[kernels] {name} {what}: max_abs_err {err:.3e} (atol {atol}), vs "
        f"plain fp32 {fields['max_abs_err_vs_fp32']:.3e} (atol {a32}, rtol "
        f"{r32}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{lib_ms:.4f} ms, bound {bound * 1e3:.4f} ms ({nbytes} B = "
        f"{t_bytes * 1e3:.4f} ms, {flops} flop = {t_ops * 1e3:.4f} ms at "
        f"{c.rate_dtype}); {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
        f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
    fields.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": lib_ms})
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
        "paged_attention_ragged_q8": [
            (f"q {d} Qmax={qm}", lambda d=d, qm=qm: dense_case(
                torch, dev, d, qm, seed, q8=True))
            for qm in (CHUNK, 1) for d in (bf16, f32)],
        "mla_paged_attention_ragged": [
            (f"pool {d} Qmax={qm}", lambda d=d, qm=qm: mla_case(
                torch, dev, d, qm, seed))
            for qm in (CHUNK, 1) for d in (bf16, f32)],
    }
    rows = {}
    for name, cases in plan.items():
        row = {"name": name, "route": "cuda", "source": KERNELS[name][1],
               "replaces": KERNELS[name][0], "cases": {}}
        for i, (what, build) in enumerate(cases):
            what = what.replace("torch.", "")
            fields = measure(torch, name, build(), what)
            torch.cuda.empty_cache()
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


def engine(model, dev, *, hbm, fuse=True, max_len=560):
    from repro_torch.core.engines import EngineSpec
    from repro_torch.serving import ServeConfig, ServingEngine
    return ServingEngine(model, ServeConfig(
        max_len=max_len, page_tokens=16, max_batch_seqs=8,
        prefill_chunk_tokens=CHUNK, fuse_ticks=fuse,
        engine_spec=EngineSpec(engine="paged", kv_hbm_bytes=hbm)),
        device=dev)


def free(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def serve(torch, dev, seed, what, model, entry):
    """Phase 3's workload through ``model`` on a 1 GiB pool, with the
    launch counts set to 0 just before and read just after; checks and
    returns (launches of ``entry``, pool pages)."""
    from repro_torch.kernels.paged_attention import ops
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
    launches = entry.launches
    others = {e.__name__: e.launches for e in ops.ENTRIES
              if e is not entry and e.launches}
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
            or others:
        raise AssertionError(f"{what}: {launches} {entry.__name__} launches "
                             f"for {s['step_calls']} steps; others {others}")
    pages = eng.tiered.pool_pages
    log(f"[{what}] {cfg.name} {cfg.num_layers} layers, {model.dtype}, "
        f"{eng.desc.family} pool: {len(reqs)} requests, prompts "
        f"{[len(r.prompt) for r in reqs]}, {new} new tokens in {wall:.3f} s "
        f"= {new / wall:.2f} tok/s (incl. prefill); ticks {s['sched_ticks']}, "
        f"step_calls {s['step_calls']}, {entry.__name__} launches "
        f"{launches}, mirror_d2h_bytes {s['mirror_d2h_bytes']}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, pool pages "
        f"{pages} of {eng.desc.page_group_bytes} B")
    return launches, pages


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


def unfused(torch, dev, seed, what, model4, ref4, entry, first=None):
    """The 4-layer run with ``fuse_ticks=False``: prompt chunks go token
    by token through ``entry`` (a decode entry)."""
    from repro_torch.kernels.paged_attention import ops
    got = requests(4, 64, 400, 16, model4.cfg.vocab_size, seed + 2)
    eng = engine(model4, dev, hbm=1 << 30, fuse=False)
    ops.reset_launch_counts()
    eng.generate(got)
    torch.cuda.synchronize()
    launches = entry.launches
    if launches <= 0:
        raise AssertionError(f"{what}: {entry.__name__} never launched")
    check_identical(torch, model4, got, ref4, what, first)
    log(f"[{what}] 4-layer fp32 fuse_ticks=False: token-identical, "
        f"{entry.__name__} launches {launches}, all: "
        f"{ {e.__name__: e.launches for e in ops.ENTRIES} }")
    return launches


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
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops
    dev = torch.device("cuda", 0)
    t0 = time.time()

    def stamp(phase):
        log(f"[time] {phase} done at {time.time() - t0:.1f} s")

    phase_env(torch)
    rows = phase_kernels(torch, dev, args.seed)
    stamp("kernels")

    dense = get_config("internlm2-1.8b")
    model = make_model(torch, dense, torch.bfloat16, dev, args.seed)
    rows["paged_attention_ragged"]["launches"], bf16_pages = serve(
        torch, dev, args.seed, "serve", model, ops.paged_attention_ragged)
    del model
    free(torch)
    stamp("serve")
    model4, ref4 = parity(torch, dev, args.seed, "parity", dense)
    stamp("parity")
    rows["paged_attention"]["launches"] = unfused(
        torch, dev, args.seed, "unfused", model4, ref4, ops.paged_attention)
    del model4
    free(torch)
    stamp("unfused")

    model = make_model(torch, dense, torch.bfloat16, dev, args.seed, "int8")
    row = rows["paged_attention_ragged_q8"]
    row["launches"], int8_pages = serve(
        torch, dev, args.seed, "serve-int8", model,
        ops.paged_attention_ragged_q8)
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
    row["decode_launches"] = unfused(torch, dev, args.seed, "unfused-int8",
                                     model4, ref4, ops.paged_attention_q8,
                                     first=CHUNK)
    del model4
    free(torch)
    stamp("parity-int8")

    mla = get_config("deepseek-v2-236b-noexperts")
    model = make_model(torch, mla, torch.bfloat16, dev, args.seed)
    row = rows["mla_paged_attention_ragged"]
    row["launches"], _ = serve(torch, dev, args.seed, "serve-mla", model,
                               ops.mla_paged_attention_ragged)
    del model
    free(torch)
    stamp("serve-mla")
    model4, ref4 = parity(torch, dev, args.seed, "parity-mla", mla,
                          full_width_check=False)
    row["decode_launches"] = unfused(torch, dev, args.seed, "unfused-mla",
                                     model4, ref4, ops.mla_paged_attention)
    del model4
    free(torch)
    stamp("parity-mla")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
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
