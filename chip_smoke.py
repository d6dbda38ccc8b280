#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero, with
no result line, without them or outside a checkout of the repo. Phases —
each raises on failure, and any failure ends the run with a traceback:

1. env     — torch/CUDA/nvcc versions and the card; builds every kernel
             source (one ``nvcc`` per source, all started together).
2. kernels — each kernel at the main path's shapes (B=8, H=16, K=8, D=128,
             T=16, MP=64, Qmax 128 and 1; mixed lengths, a q_len=0 row,
             garbage past every row's live pages) in fp32 and bf16: held
             against its plain PyTorch version (bf16 also against the
             plain fp32 version on the same bf16 inputs, to one bf16 ulp),
             the bitwise pins, and CUDA-event times beside the bound and a
             library call.
3. serve   — full-width InternLM2-1.8B (random weights from --seed) in bf16
             through ``ServingEngine.generate()``, pooled and fused: 8
             requests, prompts of 64–512 tokens, 32 new tokens each.
4. parity  — full width in fp32: ``generate()`` against the dense
             ``generate_sequential()``; then a 4-layer tight-pool run that
             must preempt and stay token-identical.
5. unfused — the 4-layer run with ``fuse_ticks=False``: prompt chunks go
             token by token through the decode kernel.

The last lines are the card's name and power limit, a ``{"kernels": ...}``
JSON line, and ``{"ok": true, "device": {...}}``.
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
# bf16 kernel vs the plain fp32 version on the same bf16 values: the
# kernel's math is fp32, so only the output's rounding to bf16 (at most
# half an ulp, 2^-8 relative) may differ. Accumulating in bf16, or
# dropping part of a row, fails this.
TOL_BF16_VS_FP32 = (1e-5, 2 ** -8)
KERNELS = {
    "paged_attention_ragged": "src/repro/kernels/paged_attention/kernel.py:284",
    "paged_attention": "src/repro/kernels/paged_attention/kernel.py:93",
}


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
        log(f"[env] built {src.relative_to(ROOT)}: {len(regs)} kernels; "
            f"{regs[:3]}")
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


def kernel_inputs(torch, dev, dtype, qmax, seed):
    """Main-path shapes with a q_len=0 row, mixed lengths, distinct live
    pages, garbage table tails and random (garbage) slots past lengths."""
    B, H, K, D, T, MP = 8, 16, 8, 128, 16, 64
    P = B * MP + 64
    g = torch.Generator(dev).manual_seed(seed)
    q = torch.randn((B, qmax, H, D), generator=g, device=dev).to(dtype)
    pk = torch.randn((P, T, K, D), generator=g, device=dev).to(dtype)
    pv = torch.randn((P, T, K, D), generator=g, device=dev).to(dtype)
    if qmax == 1:
        q_lens = [0, 1, 1, 1, 1, 1, 1, 1]      # row 0: lengths == 0
        ctx = [0, 0, 15, 16, 300, 701, 1023, 64]
    else:
        q_lens = [0, 1, qmax, 57, 1, qmax, 3, 1]
        ctx = [5, 300, 0, 700, 1023, 512, 64, 17]
    q_lens = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    lengths = torch.tensor(ctx, dtype=torch.int32, device=dev) + q_lens
    perm = torch.randperm(P, generator=g, device=dev)[:B * MP]
    table = perm.reshape(B, MP).to(torch.int32)
    for b in range(B):
        live = -(-int(lengths[b]) // T)
        table[b, live:] = torch.randint(-P, 3 * P, (MP - live,), generator=g,
                                        device=dev, dtype=torch.int32)
    return q, pk, pv, table, lengths, q_lens


def poison_dead(torch, pk, pv, table, lengths):
    """Overwrite every slot a row may not see (past its length, and whole
    pages past its live ones) with huge values."""
    pk, pv = pk.clone(), pv.clone()
    T, P = pk.shape[1], pk.shape[0]
    tbl = table.tolist()
    lives = [-(-int(n) // T) for n in lengths.tolist()]
    live_pages = {tbl[b][lp] for b, live in enumerate(lives)
                  for lp in range(live)}
    for b, live in enumerate(lives):
        n = int(lengths[b])
        if n % T:
            phys = tbl[b][live - 1]
            pk[phys, n % T:] = 1e4
            pv[phys, n % T:] = -1e4
        for phys in tbl[b][live:]:
            if 0 <= phys < P and phys not in live_pages:
                pk[phys] = 3e4
                pv[phys] = -3e4
    return pk, pv


def work(lengths, q_lens, qmax, H, K, D, T, itemsize):
    """Bytes the function must move and flops it must do on these inputs:
    live K/V pages of rows with queries, q, table, output; QK^T and P.V
    over each valid query's causal span."""
    nbytes, flops = 0, 0
    for n, ql in zip(lengths.tolist(), q_lens.tolist()):
        if ql > 0:
            nbytes += -(-n // T) * T * K * D * 2 * itemsize
            flops += sum(4 * D * (n - ql + i + 1) for i in range(ql)) * H
    B = len(lengths)
    nbytes += 2 * B * qmax * H * D * itemsize + B * 64 * 4 + 2 * B * 4
    return nbytes, flops


def library_call(torch, q, pk, pv, table, lengths, q_lens):
    """``F.scaled_dot_product_attention`` over K/V gathered densely through
    the block table (a yardstick only — the port never calls it)."""
    F = torch.nn.functional
    B, Qm, H, D = q.shape
    P, T, K, _ = pk.shape
    tbl = table.long().clamp(0, P - 1)
    k = pk[tbl].reshape(B, -1, K, D).transpose(1, 2)
    v = pv[tbl].reshape(B, -1, K, D).transpose(1, 2)
    S = k.shape[2]
    qpos = (lengths - q_lens).long()[:, None] + torch.arange(Qm,
                                                             device=q.device)
    mask = torch.arange(S, device=q.device)[None, None, :] <= qpos[:, :, None]
    mask = mask[:, None]
    qt = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def phase_kernels(torch, dev, seed):
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ragged_ref, paged_attention_ref)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for name, qmax in (("paged_attention_ragged", 128),
                       ("paged_attention", 1)):
        row = {"name": name, "route": "cuda",
               "source": "src/repro_torch/kernels/paged_attention/csrc/"
                         "paged_attention.cu",
               "replaces": KERNELS[name]}
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            q, pk, pv, table, lengths, q_lens = kernel_inputs(
                torch, dev, dtype, qmax, seed)
            if name == "paged_attention":
                args = (q[:, 0], pk, pv, table, lengths)
                kern = lambda: ops.paged_attention(*args)        # noqa: E731
                plain = lambda: paged_attention_ref(*args)       # noqa: E731
            else:
                args = (q, pk, pv, table, lengths, q_lens)
                kern = lambda: ops.paged_attention_ragged(*args)  # noqa: E731
                plain = lambda: paged_attention_ragged_ref(*args)  # noqa: E731
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            atol, rtol = TOL[dtype_name]
            torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                       rtol=rtol)
            err = float((out.float() - ref.float()).abs().max())
            if dtype_name == "bfloat16":
                # same bf16 values, plain math in fp32
                up = [a.float() if a.is_floating_point() else a for a in args]
                ref32 = (paged_attention_ref(*up) if name == "paged_attention"
                         else paged_attention_ragged_ref(*up))
                a32, r32 = TOL_BF16_VS_FP32
                torch.testing.assert_close(out.float(), ref32, atol=a32,
                                           rtol=r32)
                err32 = float((out.float() - ref32).abs().max())
                row["max_abs_err_vs_fp32"] = err32
                log(f"[kernels] {name} bf16 vs plain fp32 on bf16 inputs: "
                    f"max_abs_err {err32:.3e} (atol {a32}, rtol {r32})")
            # bitwise pins: padding slots and q_len == 0 rows are zero,
            # dead pages change nothing, ragged at q_len == 1 is decode
            o4 = out if out.ndim == 4 else out[:, None]
            for b in range(q.shape[0]):
                if not bool((o4[b, int(q_lens[b]):] == 0).all()):
                    raise AssertionError(f"{name}: row {b} padding not 0")
            pk2, pv2 = poison_dead(torch, pk, pv, table, lengths)
            out2 = (ops.paged_attention(q[:, 0], pk2, pv2, table, lengths)
                    if name == "paged_attention" else
                    ops.paged_attention_ragged(q, pk2, pv2, table, lengths,
                                               q_lens))
            if not torch.equal(out2, out):
                raise AssertionError(f"{name}: dead pages changed the output")
            if name == "paged_attention_ragged":
                ones = (q_lens == 1).nonzero().flatten()
                dec = ops.paged_attention(q[:, 0], pk, pv, table, lengths)
                if not torch.equal(out[ones, 0], dec[ones]):
                    raise AssertionError("ragged at q_len=1 != decode entry")
            itemsize = q.element_size()
            nbytes, flops = work(lengths, q_lens, qmax, 16, 8, 128, 16,
                                 itemsize)
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / FLOPS_PER_S[dtype_name]
            bound = max(t_bytes, t_ops)
            ms = cuda_ms(torch, kern, 50)
            plain_ms = cuda_ms(torch, plain, 5)
            lib_ms = cuda_ms(torch, library_call(torch, q, pk, pv, table,
                                                 lengths, q_lens), 20)
            log(f"[kernels] {name} {dtype_name} Qmax={qmax}: max_abs_err "
                f"{err:.3e} (atol {atol}); kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                f"{bound * 1e3:.4f} ms ({nbytes} B = {t_bytes * 1e3:.4f} ms, "
                f"{flops} flop = {t_ops * 1e3:.4f} ms); "
                f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
            row[f"max_abs_err_{dtype_name}"] = err
            if dtype_name == "bfloat16":          # the serve phase's dtype
                row.update({"max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms,
                            "bound_ms": bound * 1e3,
                            "bound_by": ("bytes" if t_bytes >= t_ops
                                         else "operations"),
                            "library_ms": lib_ms})
        results[name] = row
    return results


# ------------------------------------------------------------ phases 3-5
def make_model(torch, cfg, dtype, dev, seed):
    from repro_torch.models import LM
    return LM(cfg, dtype=dtype, device=dev).init(
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
        prefill_chunk_tokens=128, fuse_ticks=fuse,
        engine_spec=EngineSpec(engine="paged", kv_hbm_bytes=hbm)),
        device=dev)


def phase_serve(torch, dev, seed):
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops
    cfg = get_config("internlm2-1.8b")
    model = make_model(torch, cfg, torch.bfloat16, dev, seed)
    reqs = requests(8, 64, 512, 32, cfg.vocab_size, seed)
    eng = engine(model, dev, hbm=1 << 30)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.paged_attention_ragged.launches
    s = eng.stats()
    new = sum(len(r.generated) for r in reqs)
    if not all(r.done and len(r.generated) == 32 for r in reqs):
        raise AssertionError("serve: a request did not finish")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated):
        raise AssertionError("serve: a token is out of the vocab")
    if s["mirror_d2h_bytes"] != 0:
        raise AssertionError(f"serve: mirror bytes {s['mirror_d2h_bytes']}")
    if s["step_calls"] != s["sched_ticks"]:
        raise AssertionError("serve: step_calls != ticks")
    if launches <= 0 or launches != cfg.num_layers * s["step_calls"]:
        raise AssertionError(f"serve: {launches} ragged launches for "
                             f"{s['step_calls']} steps")
    log(f"[serve] internlm2-1.8b bf16: {len(reqs)} requests, prompts "
        f"{[len(r.prompt) for r in reqs]}, {new} new tokens in {wall:.3f} s "
        f"= {new / wall:.2f} tok/s (incl. prefill); ticks {s['sched_ticks']}, "
        f"step_calls {s['step_calls']}, ragged launches {launches}, "
        f"mirror_d2h_bytes {s['mirror_d2h_bytes']}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, pool pages "
        f"{eng.tiered.pool_pages}")
    return launches


def first_divergence(torch, model, req, ref_tokens):
    """Check a token mismatch is a near-tie of the reference: returns
    (step, margin, std) at the first differing token."""
    import numpy as np
    step = next(i for i, (a, b) in enumerate(zip(req.generated, ref_tokens))
                if a != b)
    prefix = np.concatenate([req.prompt, np.asarray(ref_tokens[:step],
                                                    np.int32)])
    logits, _ = model.prefill(torch.as_tensor(prefix[None], device=model.device),
                              len(prefix))
    lv = logits[0, -1, :model.cfg.vocab_size].double()
    top = torch.topk(lv, 2).values
    return step, float(top[0] - top[1]), float(lv.std())


def check_identical(torch, model, got, ref, what):
    for r, rr in zip(got, ref):
        if r.generated == rr.generated:
            continue
        step, margin, std = first_divergence(torch, model, rr, rr.generated)
        log(f"[{what}] request {r.rid} differs at step {step}: reference "
            f"top-2 margin {margin:.3e}, logit std {std:.3e}")
        if margin >= 1e-4 * std:
            raise AssertionError(f"{what}: request {r.rid} diverged at step "
                                 f"{step} with a clear margin")


def phase_parity(torch, dev, seed):
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("internlm2-1.8b")
    model = make_model(torch, cfg, torch.float32, dev, seed)
    ref = requests(4, 64, 400, 16, cfg.vocab_size, seed + 1)
    engine(model, dev, hbm=4 << 30).generate_sequential(ref)
    got = requests(4, 64, 400, 16, cfg.vocab_size, seed + 1)
    eng = engine(model, dev, hbm=4 << 30)
    eng.generate(got)
    check_identical(torch, model, got, ref, "parity")
    log(f"[parity] internlm2-1.8b fp32: generate() == generate_sequential() "
        f"on {len(got)} requests x 16 tokens (ticks "
        f"{eng.stats()['sched_ticks']})")
    del model, eng

    cfg4 = dataclasses.replace(cfg, num_layers=4)
    model4 = make_model(torch, cfg4, torch.float32, dev, seed)
    ref4 = requests(4, 64, 400, 16, cfg.vocab_size, seed + 2)
    engine(model4, dev, hbm=1 << 30).generate_sequential(ref4)
    group = cfg4.num_layers * 16 * 2 * cfg4.num_kv_heads * cfg4.head_dim * 4
    tight = requests(4, 64, 400, 16, cfg.vocab_size, seed + 2)
    eng = engine(model4, dev, hbm=40 * group)
    eng.generate(tight)
    s = eng.stats()
    if s["preempts"] <= 0:
        raise AssertionError("parity: the tight pool did not preempt")
    check_identical(torch, model4, tight, ref4, "parity-tight")
    log(f"[parity] 4-layer fp32 tight pool ({eng.tiered.pool_pages} pages): "
        f"token-identical with {s['preempts']} preempts, "
        f"{s['pool_page_spills']} page spills")
    return model4, ref4


def phase_unfused(torch, dev, seed, model4, ref4):
    from repro_torch.kernels.paged_attention import ops
    got = requests(4, 64, 400, 16, model4.cfg.vocab_size, seed + 2)
    eng = engine(model4, dev, hbm=1 << 30, fuse=False)
    ops.reset_launch_counts()
    eng.generate(got)
    torch.cuda.synchronize()
    launches = ops.paged_attention.launches
    if launches <= 0:
        raise AssertionError("unfused: the decode kernel never launched")
    check_identical(torch, model4, got, ref4, "unfused")
    log(f"[unfused] 4-layer fp32 fuse_ticks=False: token-identical, decode "
        f"launches {launches}, ragged launches "
        f"{ops.paged_attention_ragged.launches}")
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
    dev = torch.device("cuda", 0)
    t0 = time.time()
    phase_env(torch)
    rows = phase_kernels(torch, dev, args.seed)
    log(f"[time] kernels done at {time.time() - t0:.1f} s")
    rows["paged_attention_ragged"]["launches"] = phase_serve(torch, dev,
                                                             args.seed)
    log(f"[time] serve done at {time.time() - t0:.1f} s")
    model4, ref4 = phase_parity(torch, dev, args.seed)
    log(f"[time] parity done at {time.time() - t0:.1f} s")
    rows["paged_attention"]["launches"] = phase_unfused(torch, dev,
                                                        args.seed, model4,
                                                        ref4)
    log(f"[time] unfused done at {time.time() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err_float32", "max_abs_err_vs_fp32")
    print(smi_line())
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
