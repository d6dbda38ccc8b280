"""Batched serving engine: continuous-batching decode over the pooled
paged KV engine (the paper's NVPages design on the device).

The port's counterpart of the JAX package's ``ServingEngine`` on its
pooled, mirror-free path. The KV engine (``paged``, from the port's own
registry) owns device-resident page planes; admission scatters a
prompt's prefilled KV into pool pages on device, and every scheduler tick
is ONE ragged forward (:meth:`ServingEngine.step_batch`): decode rows
contribute one new token, prefill-chunk rows their next chunk, and the
model family's hand-written ragged kernel (dense, int8 or MLA paged
attention) attends them all in the same launch, layer by layer, through
the block table. The pool's planes come from the model's cache
descriptor. No KV byte crosses the device→host link on this path:
``mirror_d2h_bytes`` stays 0.

``generate()`` runs requests through the continuous-batching
:class:`~repro_torch.serving.scheduler.Scheduler` (admission, chunked
prefill, preemption to the host/disk tiers and restore under pool
pressure). ``generate_sequential()`` keeps the one-request-at-a-time loop
over the dense cache as the reference the scheduler must match token for
token. ``fuse_ticks=False`` keeps the unfused baseline: prefill chunks run
token by token through the single-token decode kernel (``extend_one``).

The serving features around the tick are the reference's:

* **prefix cache** (``EngineSpec.prefix_cache_tokens``): a token radix
  index over shared pool pages; a cache-hit admission splices the block
  table instead of prefilling, and the first write inside a still-shared
  page copies it on device (copy-on-write);
* **speculative decode** (``speculate_k``): decode rows carry ``1 + k``
  query slots in the same ragged launch, the launch's per-slot argmax
  verifies the drafts (one device→host copy a tick), and rejected slots
  roll back;
* **faults and the journal** (``fault_plan``, ``journal``): deterministic
  fault injection, and a crash-consistent token journal over the NVMM log
  tier from which :meth:`ServingEngine.recover` resumes a crashed run.

Not ported yet, and refused at construction rather than ignored: the
dense-mirror path (``paged_decode=False``; the ``log``/``kvhybrid``
engines are not registered).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.clock import SimClock
from repro_torch.core.engines import EngineSpec, create_kv_engine
from repro_torch.core.kvcache import KVSpec
from repro_torch.serving import batching
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.speculative import NGramProposer


@dataclass
class ServeConfig:
    max_len: int = 512
    page_tokens: int = 16          # geometry (KVSpec)
    greedy: bool = True
    # the shared KV-engine config object (engine name, pool budget, tiering)
    engine_spec: EngineSpec = field(default_factory=EngineSpec)
    # continuous-batching scheduler knobs
    max_batch_seqs: int = 8        # running-batch width cap
    max_batch_tokens: Optional[int] = None   # running-batch token cap
    min_running: int = 1           # preemption floor: progress guarantee
    # mirror-free pooled decode: None/True = pooled (the only ported path);
    # False asks for the dense mirror, which is refused
    paged_decode: Optional[bool] = None
    # chunked prefill: prompts longer than this admit chunk by chunk across
    # ticks (None → max_batch_tokens; chunking off when both are None)
    prefill_chunk_tokens: Optional[int] = None
    # fused mixed-batch ticks: every scheduler tick is ONE ragged forward
    # over decode rows AND prefill-chunk rows; False keeps the
    # token-by-token chunk baseline
    fuse_ticks: bool = True
    # forward-progress guard: a running row must advance within this many
    # consecutive running ticks, else the scheduler raises
    progress_tick_limit: int = 4
    # speculative multi-token decode: each running decode row proposes up
    # to k draft tokens per fused tick, verified by the same ragged
    # forward; accepted runs commit, rejected tails roll back. 0 = off.
    # Greedy outputs stay token-identical either way.
    speculate_k: int = 0
    # proposer override: any DraftProposer (serving/speculative.py); None →
    # the self-drafting NGramProposer
    draft_proposer: Optional[object] = None
    # a FaultPlan (serving/faults.py) turns on deterministic fault
    # injection — failed/delayed transfers, lost host pages, transfer
    # stalls, a crash at a tick boundary. None = no injection.
    fault_plan: Optional[object] = None
    # crash-consistent token journal (serving/journal.py): every scheduler
    # tick appends its committed tokens through the NVMM log tier; after a
    # CrashFault a fresh engine sharing the SAME journal object calls
    # recover() to rebuild and resume. None = no journal.
    journal: Optional[object] = None


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    generated: list = field(default_factory=list)
    done: bool = False


def _refuse_unported(cfg: ServeConfig) -> None:
    if cfg.paged_decode is False:
        raise NotImplementedError(
            "not ported yet: paged_decode=False, the dense-mirror path "
            "(ROADMAP.md, queue 1: Mirror paths and the log/kvhybrid KV "
            "engines)")


class ServingEngine:
    def __init__(self, model, cfg: ServeConfig, *, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine asked "
                             f"for {self.device}")
        spec_cfg = cfg.engine_spec
        if not isinstance(spec_cfg, EngineSpec):
            raise TypeError(f"engine_spec must be an EngineSpec, got "
                            f"{type(spec_cfg).__name__}: {spec_cfg!r}")
        _refuse_unported(cfg)
        self.model = model
        self.cfg = cfg
        mcfg = model.cfg
        self.clock = SimClock()
        # the model family's cache-layout descriptor rides inside KVSpec so
        # the engine sizes, allocates and byte-accounts the pool from the
        # SAME plane list the model's paged steps consume
        self.desc = model.cache_descriptor(cfg.page_tokens)
        spec = KVSpec(num_layers=mcfg.num_layers, kv_heads=mcfg.num_kv_heads,
                      head_dim=mcfg.head_dim, page_tokens=cfg.page_tokens,
                      desc=self.desc)
        self.tiered = create_kv_engine(spec_cfg, spec, self.clock)
        # deterministic fault injection + crash-consistent journal. The
        # injector attaches BEFORE init_pool so the transfer pipeline is
        # constructed with it; the journal's WAL region survives a
        # simulated crash (the object outlives the engine), only its clock
        # is re-attached to this engine's fresh one.
        self.injector = None
        if cfg.fault_plan is not None:
            self.injector = FaultInjector(cfg.fault_plan)
            self.tiered.set_fault_injector(self.injector)
        self.journal = cfg.journal
        if self.journal is not None:
            self.journal.attach_clock(self.clock)
        self.mirror_d2h_bytes = 0      # device→host mirror traffic (exact)
        self.sched_stats: dict = {}    # last generate()'s scheduler counters
        self.fused = bool(cfg.fuse_ticks) and model.supports_ragged_step()
        # step-shape ladder bookkeeping: every step buckets its (path,
        # batch-width, Qmax) to powers of two (pad + mask); the counters
        # count distinct shapes, as the JAX package counts jit compiles
        self.jit_stats = {"prefill_calls": 0, "step_calls": 0,
                          "fused_steps": 0, "step_compiles": 0,
                          "step_cache_hits": 0}
        self._step_shapes: set = set()
        self.max_pages = -(-cfg.max_len // cfg.page_tokens)
        # liveness floor: the pool must hold one max-length sequence plus
        # a reserve page, or a lone running sequence could exhaust it
        budget_pages = spec_cfg.kv_hbm_bytes // self.desc.page_group_bytes
        if not (self.tiered.supports_pool()
                and budget_pages >= self.max_pages + 1):
            raise ValueError(
                f"pooled serving needs a pool-capable KV engine and an HBM "
                f"budget of at least {self.max_pages + 1} pool pages; got "
                f"engine={self.tiered.engine_name!r}, budget_pages="
                f"{budget_pages}")
        if cfg.max_len % cfg.page_tokens:
            raise ValueError(
                f"pooled decode needs max_len ({cfg.max_len}) to be a "
                f"multiple of page_tokens ({cfg.page_tokens})")
        self.pooled = True
        self.tiered.init_pool(device=self.device)
        # host-facing mirror appends are dense-layout: an int8 or MLA pool
        # cannot absorb them, so the sequential reference counts its
        # mirror bytes but skips the tiered append (generate() never
        # mirrors)
        self._mirror_appends_ok = self.desc.kernel == "dense"
        # speculative decode: decode rows carry 1 + k query slots, the
        # per-slot logits of the SAME fused forward verify the drafts, and
        # rejected tails roll back (partial commit)
        self.speculate_k = max(int(cfg.speculate_k), 0)
        if self.speculate_k and not self.fused:
            raise ValueError(
                f"speculate_k={self.speculate_k} needs fused ragged ticks "
                f"(fuse_ticks=True); got fuse_ticks={cfg.fuse_ticks}")
        self.proposer = None
        if self.speculate_k:
            if cfg.draft_proposer is not None:
                self.proposer = cfg.draft_proposer
            else:
                self.proposer = NGramProposer()
        self.spec_stats = {"spec_proposed": 0, "spec_accepted": 0}
        # cross-request prefix cache: token-keyed radix index over shared
        # pool pages; a cache-hit admission splices the block table instead
        # of prefilling
        self.prefix_cache = None
        if spec_cfg.prefix_cache_tokens > 0:
            self.prefix_cache = PrefixCache(
                self.tiered, capacity_tokens=spec_cfg.prefix_cache_tokens)

    # -------------------------------------------------------------- mirroring
    def _mirror_kv(self, rid: int, cache, pos: int):
        """Mirror the newly appended token's KV into the tiered cache: the
        ``(L, K, D)`` token is sliced on device so only the single fp16
        token crosses the device→host link. An MLA cache has no ``k`` and
        mirrors nothing."""
        if "k" not in cache:
            return
        tok = batching.gather_new_kv(
            cache["k"], cache["v"],
            torch.tensor([pos], device=self.device))[0].cpu()
        self.mirror_d2h_bytes += tok.numel() * tok.element_size()
        if self._mirror_appends_ok:
            self.tiered.append(rid, tok)

    def _mirror_prefill(self, rid: int, cache, n: int):
        """Mirror the whole prompt's KV as one batched append (sliced to the
        prompt's ``n`` tokens on device, cast to fp16 before transfer)."""
        if "k" not in cache or n == 0:
            return
        toks = batching.gather_prefill_kv(cache["k"], cache["v"], n).cpu()
        self.mirror_d2h_bytes += toks.numel() * toks.element_size()
        if self._mirror_appends_ok:
            self.tiered.append(rid, toks)

    # ------------------------------------------------------------- generation
    def _prefill(self, toks):
        return self.model.prefill(
            torch.as_tensor(np.asarray(toks)[None, :], device=self.device),
            self.cfg.max_len)

    def prefill_one(self, req: Request, n: Optional[int] = None,
                    tokens: Optional[np.ndarray] = None):
        """Prefill one request at batch=1 (the first ``n`` prompt tokens
        when chunked admission splits it) and scatter its KV into pool
        pages on device. ``tokens`` overrides the prompt (re-admission of
        a shed row). Returns (logits, cache row) for the scheduler."""
        src = req.prompt if tokens is None else tokens
        toks = src if n is None else src[:n]
        self.jit_stats["prefill_calls"] += 1
        logits, cache = self._prefill(toks)
        return logits, self._pool_admit(req.rid, cache, toks.shape[0])

    def admit_prefix(self, req: Request):
        """Try a prefix-cache splice for ``req``: on a hit the sequence
        adopts the shared pool pages covering its longest cached prefix —
        ZERO prefill compute for the covered tokens — and returns
        ``(cache_row, covered)``; the scheduler prefills only
        ``prompt[covered:]``. None on a miss or when sharing is off."""
        if self.prefix_cache is None:
            return None
        covered = self.prefix_cache.match_and_splice(req.rid, req.prompt)
        if covered <= 0:
            return None
        return {"pos": torch.tensor([covered], dtype=torch.int32,
                                    device=self.device)}, covered

    def on_prompt_complete(self, rid: int, prompt: np.ndarray) -> None:
        """A request's FULL prompt is now in the pool: publish its pages
        into the prefix index so later admissions can splice them."""
        if self.prefix_cache is not None:
            self.prefix_cache.insert(rid, prompt)

    def _pool_admit(self, rid: int, cache, n: int) -> dict:
        """Move a fresh prompt's prefilled cache into the engine-owned pool
        (one on-device scatter — zero device→host bytes) and shrink the
        row's cache to its position vector."""
        if n == 0:
            return {"pos": cache["pos"]}
        phys = self.tiered.alloc_prefill(rid, n)
        pools = batching.scatter_prefill_planes(
            self.tiered.pool_views(),
            tuple(cache[p.name] for p in self.desc.paged_planes), phys, n)
        self.tiered.commit_prefill_planes(pools, rid, n)
        return {"pos": cache["pos"]}

    def _count_step(self, path: str, width: int, qmax: int) -> None:
        """Track step-shape reuse: the power-of-two ladder makes ``(path,
        width, qmax)`` a small fixed set, so ``step_compiles`` (distinct
        shapes) stops growing after warmup."""
        self.jit_stats["step_calls"] += 1
        key = (path, width, qmax)
        if key in self._step_shapes:
            self.jit_stats["step_cache_hits"] += 1
        else:
            self._step_shapes.add(key)
            self.jit_stats["step_compiles"] += 1

    def decode_batch(self, rids: list, caches: list, tokens: list,
                     mirrored: bool):
        """One batched single-token decode step (the unfused baseline's
        batched launch): the ragged step at ``q_len = 1``. Returns
        (logits, new cache rows)."""
        logit_rows, rows, _ = self.step_batch(
            rids, caches, [np.asarray([t], np.int32) for t in tokens],
            mirrored, fused=False)
        return torch.cat(logit_rows, dim=0), rows

    def publish_plan(self, rids: list, n_tokens: list) -> int:
        """Scheduler lookahead: next tick's planned batch, forwarded to the
        async tiering pipeline (a no-op without one)."""
        return self.tiered.prefetch(rids, n_tokens)

    def can_step_fused(self, rids: list, n_tokens: list) -> bool:
        """Can this tick's mixed batch be placed in one fused step?"""
        return self.tiered.can_place_step(rids, n_tokens)

    def _verify_drafts(self, logits, tok_rows, q_lens, spec) -> list:
        """Greedy draft verification against the SAME fused forward's
        per-slot logits. Row ``i``'s tokens are ``[t0, d1..ds]``
        (``s = spec[i]`` trailing drafts): slot ``j``'s argmax is the
        greedy token after consuming token ``j``, so draft ``d_{j+1}`` is
        accepted iff it equals ``argmax(slot j)`` AND every earlier draft
        was — the longest accepted prefix is exactly the sequential greedy
        run. The ``(B, Qmax)`` argmax crosses to the host in ONE copy a
        tick. Returns per-row committed counts (``1 + accepted``; chunk and
        plain decode rows commit everything)."""
        B = len(tok_rows)
        committed = list(q_lens)
        need = [i for i in range(B) if spec[i] > 0]
        if not need:
            return committed
        args = torch.argmax(logits[:B], dim=-1).cpu().numpy()   # (B, Qb)
        for i in need:
            q, s = q_lens[i], spec[i]
            acc = 0
            for j in range(s):
                if int(tok_rows[i][q - s + j]) != int(args[i, q - s + j - 1]):
                    break
                acc += 1
            committed[i] = q - s + acc
            self.spec_stats["spec_proposed"] += s
            self.spec_stats["spec_accepted"] += acc
        return committed

    def step_batch(self, rids: list, caches: list, tok_rows: list,
                   mirrored: bool, fused: bool = True,
                   spec_lens: Optional[list] = None):
        """ONE fused forward over a mixed ragged batch: decode rows carry 1
        new token (plus up to ``speculate_k`` draft tokens when speculation
        is on), prefill-chunk rows up to ``chunk_tokens``, and all of them
        attend in the same step over the device pool. Batch width and Qmax
        pad up the power-of-two ladder; padding rows ride with
        ``q_len = 0`` and are masked end to end.

        ``spec_lens[i]`` marks how many TRAILING tokens of ``tok_rows[i]``
        are unverified drafts: they scatter into the pool with the rest,
        are verified against this forward's own per-slot logits, and the
        rejected tail rolls back before anything else sees it (a partial
        commit: ``seq_len`` advances by the accepted count, pages only the
        tail used go back to the free list, and the next tick's lengths
        mask the stale slots until its writes overwrite them).

        Returns ``(logit_rows, new_rows, committed)``: per-row logits for
        each row's committed slots (``(1, committed[i], V)`` — the LAST
        slot is what the next tick's argmax reads), the new per-row
        caches, and the per-row committed token counts."""
        B = len(rids)
        q_lens = [len(t) for t in tok_rows]
        spec = [0] * B if spec_lens is None else [int(s) for s in spec_lens]
        Bb = batching.bucket_pow2(B)
        Qb = batching.bucket_pow2(max(q_lens))
        tokens = np.zeros((Bb, Qb), np.int64)
        for i, t in enumerate(tok_rows):
            tokens[i, :len(t)] = t
        qarr = np.zeros(Bb, np.int32)
        qarr[:B] = q_lens
        if fused:       # the unfused pooled decode reuses this entry at
            self.jit_stats["fused_steps"] += 1   # q_len=1; don't count it
        names = [p.name for p in self.desc.paged_planes]
        # any exception between prepare_step and commit_step must rewind
        # the pages prepare_step allocated for this tick, or they leak
        try:
            tbl, ctx = self.tiered.prepare_step(rids, q_lens, self.max_pages)
            model_pos = torch.cat([c["pos"] for c in caches]).cpu().numpy()
            if not np.array_equal(ctx, model_pos):
                raise RuntimeError(
                    f"pool/table drift: engine lengths {ctx.tolist()} "
                    f"!= model positions {model_pos.tolist()}")
            tbl_p = np.zeros((Bb, self.max_pages), np.int32)
            tbl_p[:B] = tbl
            ctx_p = np.zeros(Bb, np.int32)
            ctx_p[:B] = ctx
            cache = {"block_table": torch.from_numpy(tbl_p).to(self.device)}
            for n, v in zip(names, self.tiered.pool_views()):
                cache["pool_" + n] = v
            self._count_step("pool", Bb, Qb)
            logits, out = self.model.step_paged_ragged(
                cache, torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(ctx_p).to(self.device),
                torch.from_numpy(qarr).to(self.device))
            committed = self._verify_drafts(logits, tok_rows, q_lens, spec)
            # the step scattered in place into the engine's own planes:
            # handing them back stores the same tensors
            self.tiered.commit_step_planes(
                tuple(out["pool_" + n] for n in names), rids, committed,
                prepared=q_lens)
        except Exception:
            self.tiered.abort_step(rids)
            raise
        # a row with rejected drafts rewinds its position on device
        new_rows = [{"pos": out["pos"][i:i + 1] - (q_lens[i] - committed[i])}
                    if committed[i] != q_lens[i]
                    else {"pos": out["pos"][i:i + 1]} for i in range(B)]
        logit_rows = [logits[i:i + 1, :committed[i]] for i in range(B)]
        return logit_rows, new_rows, committed

    def extend_one(self, rid: int, cache, toks: np.ndarray, start: int,
                   mirrored: bool):
        """UNFUSED baseline (``fuse_ticks=False``): process ``toks``
        additional prompt tokens for one admitted row, each token through
        the single-token paged decode step at batch=1 — page allocation per
        token, still zero device→host bytes. Returns (logits, cache)
        positioned after the chunk."""
        logits = None
        names = [p.name for p in self.desc.paged_planes]
        for t in toks:
            tbl, _ = self.tiered.prepare_decode([rid], self.max_pages)
            pc = {"pos": cache["pos"],
                  "block_table": torch.from_numpy(tbl).to(self.device)}
            for n, v in zip(names, self.tiered.pool_views()):
                pc["pool_" + n] = v
            self._count_step("pool-chunk1", 1, 1)
            logits, out = self.model.decode_step_paged(
                pc, torch.tensor([[int(t)]], device=self.device),
                cache["pos"])
            self.tiered.commit_step_planes(
                tuple(out["pool_" + n] for n in names), [rid], [1])
            cache = {"pos": out["pos"]}
        return logits, cache

    def degraded(self) -> bool:
        """True once persistent async transfer faults flipped the tiering
        pipeline to its synchronous fallback."""
        pipe = getattr(self.tiered, "_pipeline", None)
        return bool(pipe is not None and pipe.degraded)

    def generate(self, requests: list[Request]) -> list[Request]:
        """Continuous-batching decode: all requests share one running batch,
        stepped together and preempted/restored under pool pressure. Greedy
        outputs are token-identical to :meth:`generate_sequential`."""
        from repro_torch.serving.scheduler import Scheduler
        sched = Scheduler(self, requests)
        try:
            sched.run()
        finally:
            # a CrashFault abandons the run mid-tick, but the scheduler
            # counters gathered so far are still what the caller inspects
            self.sched_stats = sched.stats.as_dict()
        self.tiered.flush_transfers()   # run-end drain: sim_time_s includes
        return requests                 # in-flight transfer tails

    def recover(self, requests: list[Request]) -> list[Request]:
        """Crash recovery: replay the journal this engine shares with the
        crashed one, rebuild each request's committed stream, and resume
        decoding the unfinished rows through the normal scheduler —
        re-admission prefills ``prompt + committed`` so greedy decode
        continues exactly where the last durable tick stopped.
        ``requests`` must be fresh Request objects carrying the original
        prompts/rids; their ``generated`` fields are overwritten from the
        journal."""
        if self.journal is None:
            raise RuntimeError(
                "recover() needs the crashed run's journal: construct this "
                "engine with ServeConfig(journal=<same ServingJournal>)")
        state, _last_tick = self.journal.replay()
        pending = []
        for req in requests:
            toks = state.get(req.rid, [])
            req.generated = [int(t) for t in toks[:req.max_new]]
            req.done = len(req.generated) >= req.max_new
            if not req.done:
                pending.append(req)
        if pending:
            self.generate(pending)
        return requests

    @torch.no_grad()
    def generate_sequential(self, requests: list[Request]) -> list[Request]:
        """Sequential reference: one request at a time, batch=1 decode over
        the dense cache (plain torch attention, no paged kernel), with the
        tiered append mirroring every token into the engine (dense pools
        only; the int8 reference counts its mirror bytes, MLA has none)."""
        for req in requests:
            logits, cache = self._prefill(req.prompt)
            self._mirror_prefill(req.rid, cache, req.prompt.shape[0])
            for _ in range(req.max_new):
                nxt = int(torch.argmax(logits[:, -1], -1)[0])
                req.generated.append(nxt)
                pos = cache["pos"]
                logits, cache = self.model.decode_step(
                    cache, torch.tensor([[nxt]], device=self.device), pos)
                self._mirror_kv(req.rid, cache, int(pos[0]))
            req.done = True
        return requests

    def stats(self) -> dict:
        journal = {} if self.journal is None else dict(self.journal.stats)
        return {"sim_time_s": self.clock.now,
                "mirror_d2h_bytes": self.mirror_d2h_bytes,
                **self.jit_stats, **self.spec_stats, **self.sched_stats,
                **journal, **self.tiered.stats}
