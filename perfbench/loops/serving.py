"""What the closed and the open serving loops share.

The system under test is the port's continuous-batching loop, the one
``ServingEngine.generate()`` runs: a ``Scheduler`` over a pooled ``paged``
``ServingEngine`` (fused ticks, bf16, native KV), its ``tick()`` called in
a loop. Requests enter the scheduler's ``waiting`` queue at the first tick
boundary after they are sent (closed loop) or due (open loop); every time
is the host's clock after a tick returns, which is when the host sees a
token in ``req.generated``.

After the window: ``memory_peak_bytes`` is read, the program is freed, and
a sample of the finished requests (drawn from the seed, the one with the
most served tokens always in it) is run through the fp32 reference: the
widest gap by which a served token's logit lies below the reference's
best is the number compared with the cell's limit.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import trace as tracing
from perfbench import traffic as gen
from perfbench import weights
from perfbench.counts import span_flops
from perfbench.bench import Outcome
from perfbench.reference import decoder as ref
from perfbench.trace import Trace

clock = time.perf_counter
PAGE_TOKENS = 16           # tokens a pool page, in every serving cell


def program_config(c: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig
    a = weights.Arch(c)
    return ModelConfig(
        name=c["name"], family="attn_dense", num_layers=a.L, d_model=a.d,
        num_heads=a.H, num_kv_heads=a.K, d_ff=a.F, vocab_size=a.V,
        head_dim=a.D, ffn_activation="swiglu" if a.gated else "gelu",
        rope_theta=a.theta, norm_eps=a.eps, tie_embeddings=a.tied,
        vocab_pad_multiple=int(c.get("vocab_pad_multiple", 256)))


def load_kernels(device) -> None:
    """Build (first run in a checkout) or load the kernel libraries the
    dense path launches, so that their cost shows as its own part."""
    if device.type != "cuda":
        return
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    load_library(paged_ops.SOURCE)
    load_library(flash_ops.SOURCE)


def build_model(cell, seed: int, device, **kw):
    from repro_torch.models.model import LM
    a = weights.Arch(cell.config)
    model = LM(program_config(cell.config), dtype=a.dtype, device=device,
               **kw)
    weights.fill_module(model, a, seed)
    return model


def percentile(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if len(xs) \
        else float("nan")


class Track:
    """One request's times on the host's clock."""
    __slots__ = ("req", "prompt_len", "due", "admitted", "first", "last",
                 "seen", "done_t")

    def __init__(self, req, due):
        self.req, self.prompt_len, self.due = req, len(req.prompt), due
        self.admitted = self.first = self.last = self.done_t = None
        self.seen = 0


class ServeRun:
    """The engine, the scheduler and the bookkeeping of one serving run."""

    def __init__(self, cell, seed, seconds, trace, device, t_start):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.device, self.t_start, self.trace_on = device, t_start, trace
        self.arch = weights.Arch(cell.config)
        self.s = cell.traffic["serve"]
        self.parts = {"imports": clock() - t_start}
        t = clock()
        load_kernels(device)
        self.parts["libraries"] = clock() - t
        t = clock()
        self.model = build_model(cell, seed, device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        self.parts["weights"] = clock() - t
        t = clock()
        self._build_engine()
        self.parts["pool"] = clock() - t
        self.tracks: dict = {}            # rid → Track, every request sent
        self.active: dict = {}            # rid → Track, not yet seen done
        self.waiting_admit: list = []     # tracks not yet out of waiting
        self.t0 = self.t1 = None
        self.tokens_in_window = 0
        self.itl: list = []
        self.pressure_peak = 0.0
        self.next_rid = 0
        # traced runs: the useful operations of the window before the
        # traced span ("counted") and the traced span's kernel calls, for
        # the per-layer metrics
        self.phase = None                 # None, "counted" or "traced"
        self.useful_flops = 0
        self.calls_paged: list = []       # rows of each fused step
        self.calls_flash: list = []       # (1, prompt, layers) past chunk
        self.trace = None

    def _build_engine(self):
        from repro_torch.core.engines.base import EngineSpec
        from repro_torch.serving.engine import ServeConfig, ServingEngine
        from repro_torch.serving.scheduler import Scheduler
        s = self.s
        cfg = ServeConfig(
            max_len=int(s["max_len"]), page_tokens=PAGE_TOKENS,
            engine_spec=EngineSpec(engine="paged",
                                   kv_hbm_bytes=int(s["kv_hbm_bytes"])),
            max_batch_seqs=int(s["max_batch_seqs"]),
            prefill_chunk_tokens=s.get("prefill_chunk_tokens"),
            fuse_ticks=True, paged_decode=True)
        self.engine = ServingEngine(self.model, cfg, device=self.device)
        if not (self.engine.pooled and self.engine.fused):
            raise RuntimeError("the engine is not pooled and fused")
        self.sched = Scheduler(self.engine, [])
        if self.trace_on:
            self._record_calls()
            Trace.warm()

    # ------------------------------------------------------------ counting
    def _record_calls(self):
        """In a traced run, count each fused step's and each prefill's
        useful operations in the window, and note their rows and lengths
        in the traced span (the per-layer metrics' work)."""
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
                        self.useful_flops += span_flops(a, start, n, head)
                if self.phase == "traced":
                    self.calls_paged.append(rows)
            return step(rids, caches, tok_rows, *args, **kw)

        def prefill_one(req, n=None, tokens=None):
            if self.phase:
                full = len(req.prompt if tokens is None else tokens)
                m = full if n is None else n
                if self.phase == "counted":
                    self.useful_flops += span_flops(a, 0, m, int(m == full))
                if self.phase == "traced" and m > self.model.chunk_size:
                    self.calls_flash.append((1, m, a.L))
            return prefill(req, n, tokens)

        eng.step_batch, eng.prefill_one = step_batch, prefill_one

    # ---------------------------------------------------------------- loop
    def send(self, r: gen.Req, due: float):
        """Hand a request to the scheduler (at a tick boundary)."""
        from repro_torch.serving.engine import Request
        rid = self.next_rid
        self.next_rid += 1
        req = Request(rid=rid, prompt=r.prompt, max_new=r.max_new)
        tr = Track(req, due)
        self.tracks[rid] = self.active[rid] = tr
        self.waiting_admit.append(tr)
        self.sched.waiting.append(req)
        return tr

    def in_window(self, t) -> bool:
        return self.t0 is not None and self.t0 <= t < self.t1

    def tick(self) -> list:
        """One scheduler tick and its bookkeeping; returns the tracks that
        finished in it."""
        ts = clock()
        with torch.profiler.record_function("perfbench.tick"):
            self.sched.tick()
        t = clock()
        if self.waiting_admit:
            still = {id(r) for r in self.sched.waiting}
            left = [tr for tr in self.waiting_admit if id(tr.req) not in still]
            for tr in left:
                tr.admitted = ts
            if left:
                self.waiting_admit = [tr for tr in self.waiting_admit
                                      if tr.admitted is None]
        win = self.in_window(t)
        done = []
        for rid, tr in list(self.active.items()):
            n = len(tr.req.generated)
            if n > tr.seen:
                for _ in range(n - tr.seen):
                    if tr.first is None:
                        tr.first = t
                    elif win and self.in_window(tr.last):
                        self.itl.append(t - tr.last)
                    tr.last = t
                if win:
                    self.tokens_in_window += n - tr.seen
                tr.seen = n
            if tr.req.done:
                tr.done_t = t
                del self.active[rid]
                done.append(tr)
        if self.phase == "counted":
            self.pressure_peak = max(self.pressure_peak,
                                     self.engine.tiered.pressure())
            if t >= self.t1 - tracing.SPAN_SECONDS:
                self._start_trace()
        return done

    def _counters(self):
        st = self.sched.stats
        return (clock(), st.ticks, st.decode_rows, st.prefill_chunks)

    def _start_trace(self):
        """The traced span: the window's last ``SPAN_SECONDS`` (all of a
        shorter window), so that stopping the profiler stalls nothing that
        the window measures. The metrics of the device trace are read over
        it; those of the counters and the host's clock over the window
        before it, which the profiler does not slow."""
        self.span1 = self._counters()
        self.trace = Trace()
        self.trace.start()
        self.phase = "traced"

    def open_window(self, t0=None):
        """Open the window at ``t0`` (now, by default): set-up ends."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.t0 = clock() if t0 is None else t0
        self.parts["ramp"] = self.t0 - self.parts.pop("_ramp_start")
        self.t1 = self.t0 + self.seconds
        self.setup_s = self.t0 - self.t_start
        if self.trace_on:
            self.span0, self.phase = self._counters(), "counted"
            if self.seconds <= tracing.SPAN_SECONDS:
                self._start_trace()

    def start_ramp(self):
        self.parts["_ramp_start"] = clock()

    @torch.no_grad()
    def warm_prefills(self, lo: int, hi: int, n: int = 16):
        """Prefill ``n`` prompts of lengths spread evenly over ``[lo,
        hi]`` through the model's own entry, outside the pool: the shapes
        of whole-prompt prefills, met before the window."""
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        for s in np.linspace(lo, hi, n).round().astype(int):
            toks = torch.randint(0, self.arch.V, (1, int(s)), generator=g,
                                 device=self.device)
            self.model.prefill(toks, int(self.s["max_len"]))
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def close_window(self):
        if self.phase == "traced":
            self.phase = None
            self.trace.stop()

    # ------------------------------------------------------------- results
    def finish(self, due_in_window: list) -> Outcome:
        """Everything after the loop: the end-to-end values, the per-layer
        context, the program freed, the reference's comparison."""
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
            span, ticks, rows, chunks = (b - a for a, b in
                                         zip(self.span0, self.span1))
            ctx.update(
                seconds=span, ticks=ticks, decode_rows=rows,
                prefill_chunks=chunks, pressure_peak=self.pressure_peak,
                queue_waits=[tr.admitted - tr.due for tr in due_in_window
                             if tr.admitted is not None
                             and tr.due < self.span1[0]],
                useful_flops=self.useful_flops,
                paged_calls=self.calls_paged, flash_calls=self.calls_flash)
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        pairs = self.sample()
        del self.sched, self.engine, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        gaps = ref.served_gaps(self.arch, self.seed, pairs, self.device)
        widest = max(float(g.max()) for g in gaps) if gaps else float("inf")
        ctx.update(served_tokens=sum(len(s) for _, s in pairs), pairs=pairs,
                   gaps=gaps)
        checks = {"logit_gap": (widest, float(self.cell.limits["logit_gap"]))}
        return Outcome(e2e, ctx, checks, len(due_in_window), failed, peak,
                       dict(self.parts), self.trace)

    def sample(self) -> list:
        """Finished requests for the reference, drawn from the seed: the
        one with the most served tokens, then others in the seed's order,
        until ``served_tokens`` are in or ``max_tokens`` would be passed."""
        chk = self.cell.traffic["check"]
        done = [tr for tr in self.tracks.values()
                if tr.done_t is not None and tr.done_t >= self.t0]
        if not done:
            return []
        rng = np.random.default_rng([int(self.seed), 3])
        longest = max(done, key=lambda tr: (len(tr.req.generated),
                                            -tr.req.rid))
        order = [longest] + [done[i] for i in rng.permutation(len(done))
                             if done[i] is not longest]
        out, served, total = [], 0, 0
        for tr in order:
            n = len(tr.req.prompt) + len(tr.req.generated)
            if out and total + n > chk["max_tokens"]:
                continue
            out.append((np.asarray(tr.req.prompt),
                        np.asarray(tr.req.generated, np.int64)))
            served += len(tr.req.generated)
            total += n
            if served >= chk["served_tokens"]:
                break
        return out

