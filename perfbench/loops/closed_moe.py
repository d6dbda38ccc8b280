"""The closed serving loop (:mod:`perfbench.loops.closed`) over a
DeepSeek-V2-style configuration: MLA attention over the latent pool (#7),
a leading dense layer, then routed experts (this chip's held share) and
shared experts.

The system under test is the same continuous-batching loop as the dense
cells': a ``Scheduler`` over a pooled, fused ``paged`` ``ServingEngine``,
bf16, the MLA pool. What differs is the configuration (read from its file
into the port's ``ModelConfig``: its routing, the experts held here, no
token dropped, YaRN), the weights (:mod:`perfbench.moe_weights`), the work
counted (:mod:`perfbench.moe_counts`: the held experts' by the rows the
program computed, from its ``expert_rows`` counter, read after the
window), the kernels built before the ramp (#7 and the K/V write), and
the fp32 reference that decides ``correct``
(:mod:`perfbench.reference.moe_decoder`). The dense loops' files belong to
the accepted benchmark and stay as they are, so the parts of them that
name the dense configuration's modules (``ServeRun``'s set-up, counting
and ``finish``, and the closed loop's ``run``) are repeated here.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import math

import numpy as np
import torch

from perfbench import moe_counts
from perfbench import moe_weights as mw
from perfbench import traffic as gen
from perfbench.bench import Outcome
from perfbench.loops.serving import PAGE_TOKENS, ServeRun, clock, percentile
from perfbench.reference import moe_decoder as ref


def program_config(c: dict):
    """The port's ``ModelConfig`` of a DeepSeek-V2-style configuration
    file, its held share of the experts included."""
    from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                          YarnConfig)
    a = mw.MoEArch(c)
    y = a.yarn
    return ModelConfig(
        name=c["name"], family="moe", num_layers=a.L, d_model=a.d,
        num_heads=a.H, num_kv_heads=a.H, d_ff=a.F, vocab_size=a.V,
        head_dim=a.dv, ffn_activation="swiglu", rope_theta=a.theta,
        rope_scaling=None if y is None else YarnConfig(
            factor=float(y["factor"]),
            original_max_position_embeddings=int(
                y["original_max_position_embeddings"]),
            beta_fast=float(y["beta_fast"]), beta_slow=float(y["beta_slow"]),
            mscale=float(y["mscale"]),
            mscale_all_dim=float(y["mscale_all_dim"])),
        norm_eps=a.eps, tie_embeddings=a.tied,
        vocab_pad_multiple=int(c.get("vocab_pad_multiple", 256)),
        moe=MoEConfig(
            num_experts=a.E, top_k=a.top_k, d_expert=a.f,
            num_shared_experts=a.n_shared, first_k_dense=a.n_dense,
            topk_method=a.topk_method, n_group=a.n_group,
            topk_group=a.topk_group, norm_topk_prob=a.norm_topk,
            routed_scaling_factor=a.scale, first_held=a.first,
            num_held=a.E_held, drop_free=True),
        mla=MLAConfig(kv_lora_rank=a.dc, q_lora_rank=a.q_lora,
                      qk_nope_head_dim=a.dn, qk_rope_head_dim=a.dr,
                      v_head_dim=a.dv))


def load_kernels(device) -> None:
    """Build (first run in a checkout) or load the kernel libraries the
    MLA path launches: #7, the K/V write, and #9 for a long prefill."""
    if device.type != "cuda":
        return
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    for src in (paged_ops.MLA_SOURCE, paged_ops.WRITE_SOURCE,
                flash_ops.SOURCE):
        load_library(src)


class MoERun(ServeRun):
    """:class:`ServeRun` with the configuration's MoE model, weights,
    counts and reference."""

    def __init__(self, cell, seed, seconds, trace, device, t_start):
        from repro_torch.models.model import LM
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.device, self.t_start, self.trace_on = device, t_start, trace
        self.arch = mw.MoEArch(cell.config)
        self.s = cell.traffic["serve"]
        # first, so that a program that cannot run the configuration stops
        # before the kernels build
        cfg = program_config(cell.config)
        self.parts = {"imports": clock() - t_start}
        t = clock()
        load_kernels(device)
        self.parts["libraries"] = clock() - t
        t = clock()
        self.model = LM(cfg, dtype=self.arch.dtype, device=device)
        mw.fill_module(self.model, self.arch, seed)
        if device.type == "cuda":
            torch.cuda.synchronize()
        self.parts["weights"] = clock() - t
        t = clock()
        self._build_engine()
        self.parts["pool"] = clock() - t
        self.tracks, self.active, self.waiting_admit = {}, {}, []
        self.t0 = self.t1 = None
        self.tokens_in_window = 0
        self.itl: list = []
        self.pressure_peak = 0.0
        self.next_rid = 0
        self.phase = None
        self.useful_flops = 0
        self.calls_paged: list = []
        self.calls_flash: list = []
        self.trace = None

    def _record_calls(self):
        """As :meth:`ServeRun._record_calls`, with this configuration's
        counts; the held experts' operations are added after the window,
        from the program's ``expert_rows``."""
        eng, a = self.engine, self.arch
        step, prefill = eng.step_batch, eng.prefill_one

        def step_batch(rids, caches, tok_rows, *args, **kw):
            if self.phase:
                rows = []
                for rid, toks in zip(rids, tok_rows):
                    start, n = eng.tiered.seq_len.get(rid, 0), len(toks)
                    rows.append((start + n, n))
                    if self.phase == "counted":
                        head = int(start + n >= self.tracks[rid].prompt_len)
                        self.useful_flops += moe_counts.span_flops(
                            a, start, n, head)
                if self.phase == "traced":
                    self.calls_paged.append(rows)
            return step(rids, caches, tok_rows, *args, **kw)

        def prefill_one(req, n=None, tokens=None):
            if self.phase:
                full = len(req.prompt if tokens is None else tokens)
                m = full if n is None else n
                if self.phase == "counted":
                    self.useful_flops += moe_counts.span_flops(
                        a, 0, m, int(m == full))
                if self.phase == "traced" and m > self.model.chunk_size:
                    self.calls_flash.append((1, m, a.L))
            return prefill(req, n, tokens)

        eng.step_batch, eng.prefill_one = step_batch, prefill_one

    def _counters(self):
        # the program's expert_rows is a tensor on the card: kept, not read
        return super()._counters() + (
            self.engine.step_stats.get("expert_rows", 0),)

    def finish(self, due_in_window: list) -> Outcome:
        """As :meth:`ServeRun.finish`, with the MoE reference."""
        ttft = [tr.first - tr.due for tr in due_in_window
                if tr.first is not None]
        failed = sum(tr.first is None for tr in due_in_window)
        e2e = {"serve_tok_s": self.tokens_in_window / self.seconds,
               "ttft_p90_ms": 1e3 * percentile(ttft, 90),
               "itl_p95_ms": 1e3 * percentile(self.itl, 95),
               "setup_s": self.setup_s}
        ctx = {"arch": self.arch, "trace": self.trace,
               "page_tokens": PAGE_TOKENS}
        if self.trace is not None:
            span, ticks, rows, chunks, experts = (
                b - a for a, b in zip(self.span0, self.span1))
            ctx.update(
                seconds=span, ticks=ticks, decode_rows=rows,
                prefill_chunks=chunks, pressure_peak=self.pressure_peak,
                queue_waits=[tr.admitted - tr.due for tr in due_in_window
                             if tr.admitted is not None
                             and tr.due < self.span1[0]],
                useful_flops=self.useful_flops + moe_counts.expert_flops(
                    self.arch, int(experts)),
                paged_calls=self.calls_paged, flash_calls=self.calls_flash)
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        pairs = self.sample()
        del self.sched, self.engine, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        gaps = ref.served_gaps(self.arch, self.seed, pairs, self.device)
        ctx.update(served_tokens=sum(len(s) for _, s in pairs), pairs=pairs,
                   gaps=gaps)
        got = gap_readings(gaps)
        checks = {n: (got[n], float(lim))
                  for n, lim in self.cell.limits.items()}
        return Outcome(e2e, ctx, checks, len(due_in_window), failed, peak,
                       dict(self.parts), self.trace)


def gap_readings(gaps) -> dict:
    """What a limits file may hold a served sample to: ``logit_gap``, the
    widest gap (as the dense cells), ``logit_gap_mean``, the mean gap over
    every served token, and ``logit_gap_p99``, its 99th percentile (inf
    where nothing was served). With random weights the router's top-6 of
    160 nearly tie, so bf16 rounding moves some tokens to another expert
    at some layer; each such token's logits move by the logits' own
    spread, which bounds the widest gap of bf16 and of fp8 alike, while
    the mean separates them. A fault confined to one row of a tick's 64
    moves the mean by about 1/64 of its gaps, but puts more than 1% of
    the served tokens far off, which the 99th percentile reads."""
    if not gaps:
        return dict.fromkeys(("logit_gap", "logit_gap_mean",
                              "logit_gap_p99"), float("inf"))
    g = torch.cat([torch.as_tensor(x).double().reshape(-1) for x in gaps])
    return {"logit_gap": float(g.max()), "logit_gap_mean": float(g.mean()),
            "logit_gap_p99": float(torch.quantile(g, 0.99))}


def run(cell, seed, seconds, trace, device, t_start):
    """The closed loop of :mod:`perfbench.loops.closed`, over
    :class:`MoERun`."""
    mix = cell.traffic
    R = MoERun(cell, seed, seconds, trace, device, t_start)
    reqs = itertools.cycle(gen.requests(mix, seed, R.arch.V,
                                        int(R.s["max_len"])))
    rng = np.random.default_rng([int(seed), 4])
    R.start_ramp()
    for _ in range(int(mix["clients"])):
        r = next(reqs)
        R.send(dataclasses.replace(
            r, max_new=max(1, math.ceil(r.max_new * rng.random()))), clock())
    for _ in range(int(mix["warmup_ticks"])):
        for _tr in R.tick():
            R.send(next(reqs), clock())
    R.open_window()
    in_window = []
    while clock() < R.t1:
        for _tr in R.tick():
            t = clock()
            if t < R.t1:
                in_window.append(R.send(next(reqs), t))
    R.close_window()
    while any(tr.first is None for tr in in_window):
        R.tick()
    return R.finish(in_window)
