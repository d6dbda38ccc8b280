"""Batched serving engine: continuous-batching decode over the tiered KV
cache (the paper's question at the KV call site).

The port's counterpart of the JAX package's ``ServingEngine``. The KV
engine (``paged``, ``log`` or ``kvhybrid``, from the port's own registry)
is built from the :class:`EngineSpec` in :class:`ServeConfig`. Two paths:

* **Pooled, mirror-free** (``paged`` when its budget holds a max-length
  sequence): the engine owns device-resident page planes; admission
  scatters a prompt's prefilled KV into pool pages on device, and every
  scheduler tick is ONE ragged forward (:meth:`ServingEngine.step_batch`)
  whose attention is the model family's hand-written ragged kernel
  (dense, int8 or MLA paged attention) over the pool, through the block
  table. No KV byte crosses the device→host link: ``mirror_d2h_bytes``
  stays 0. The SSM family (Mamba-2) pools no pages: the engine holds one
  fixed-size state row per sequence beside the block tables, and the tick
  reads the batch's rows, runs the ragged state scan and commits each
  row's committed slot (:meth:`ServingEngine._step_state_batch`).
* **Dense mirror** (``log``, ``kvhybrid``, or ``paged_decode=False``): the
  model's working KV stays in dense per-request cache rows on the device,
  and every tick is one ragged forward over them (``LM.step_ragged``,
  plain torch attention, as it is XLA code in the reference: no kernel).
  The tick's new tokens are gathered on device and mirrored, float16,
  into the tiered engine's host tiers — a prompt as one batched append
  (under ``kvhybrid`` a large write, routed to pages), decode tokens one
  per row (small writes, the log) — so rows can be preempted to disk and
  restored. ``mirror_d2h_bytes`` counts those bytes exactly. An MLA row
  has no ``k``/``v`` and mirrors nothing, as in the reference; nor does an
  SSM row (its state rides in the row) or a Zamba2 hybrid row, whose
  shared-attention KV stays in the row's ``shared_k``/``shared_v``. The
  hybrid has no cache descriptor, so it runs this path unfused on every
  engine, as in the reference.

``ServeConfig.paged_decode`` picks the path: None = pooled when the
engine has a pool and the budget fits, True = require it (``ValueError``
otherwise), False = always mirror.

``generate()`` runs requests through the continuous-batching
:class:`~repro_torch.serving.scheduler.Scheduler` (admission, chunked
prefill, preemption to the host/disk tiers and restore under pressure).
``generate_sequential()`` keeps the one-request-at-a-time loop over the
dense cache as the reference the scheduler must match token for token.
``fuse_ticks=False`` keeps the unfused baseline: prefill chunks run token
by token through the single-token decode step (``extend_one``).

The serving features around the tick are the reference's:

* **prefix cache** (``EngineSpec.prefix_cache_tokens``, pooled path
  only): a token radix index over shared pool pages; a cache-hit
  admission splices the block table instead of prefilling, and the first
  write inside a still-shared page copies it on device (copy-on-write);
* **speculative decode** (``speculate_k``): decode rows carry ``1 + k``
  query slots in the same ragged step, its per-slot argmax verifies the
  drafts (one device→host copy a tick), and rejected slots roll back (a
  partial commit on the pool; on the mirror, a truncated transfer and a
  rewound ``pos``);
* **faults and the journal** (``fault_plan``, ``journal``): deterministic
  fault injection, and a crash-consistent token journal over the NVMM log
  tier from which :meth:`ServingEngine.recover` resumes a crashed run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device, telemetry
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
    # mirror-free pooled decode: None = auto (pooled when the engine has a
    # device page pool and the budget fits), True = require it (raise if
    # it cannot), False = always the dense mirror
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
        self.model = model
        self.cfg = cfg
        mcfg = model.cfg
        self.clock = SimClock()
        # the model family's cache-layout descriptor rides inside KVSpec so
        # the engine sizes, allocates and byte-accounts the pool from the
        # SAME plane list the model's paged steps consume
        self.desc = model.cache_descriptor(cfg.page_tokens)
        spec = KVSpec(num_layers=mcfg.num_layers,
                      kv_heads=max(mcfg.num_kv_heads, 1),
                      head_dim=max(mcfg.head_dim, 1),
                      page_tokens=cfg.page_tokens, desc=self.desc)
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
        # step counters, one integer add a step each, no device sync:
        # model calls, and of the ragged steps the padded slots
        # (Σ Bb × Qb: width and Qmax bucket to powers of two), the real
        # tokens (Σ q_len) and the bytes of the logits the head returned
        # (with admission prefills'). A drop-free MoE model's work adds on
        # the device (0-d int64; ``stats()`` reads them): Σ over its
        # layers of the (token, held expert) pairs computed, the slots
        # routed (never a padding slot) and the held experts given rows
        self.step_stats = {"prefill_calls": 0, "step_calls": 0,
                           "fused_steps": 0, "step_slots": 0,
                           "step_tokens": 0, "logit_bytes": 0,
                           "expert_rows": 0, "routed_slots": 0,
                           "experts_run": 0}
        self.max_pages = -(-cfg.max_len // cfg.page_tokens)
        budget = spec_cfg.kv_hbm_bytes
        if self.desc is None:
            pool_fits, budget_pages = False, 0
        elif self.desc.has_pages:
            # liveness floor: the pool must hold one max-length sequence
            # plus a reserve page, or a lone running sequence could
            # exhaust it with nothing left to preempt
            budget_pages = budget // self.desc.page_group_bytes
            pool_fits = budget_pages >= self.max_pages + 1
        else:
            # state-row family (SSM): fixed-size rows, need one running row
            # plus one restore in flight
            budget_pages = budget // max(self.desc.seq_state_bytes, 1)
            pool_fits = budget_pages >= 2
        pool_ok = self.tiered.supports_pool() and self.desc is not None
        if cfg.paged_decode and not (pool_ok and pool_fits):
            raise ValueError(
                f"paged_decode=True needs a pool-capable KV engine, a model "
                f"family with a cache descriptor, and an HBM budget of at "
                f"least {self.max_pages + 1} pool pages; got engine="
                f"{self.tiered.engine_name!r} (supports_pool="
                f"{self.tiered.supports_pool()}), family="
                f"{mcfg.family!r}, budget_pages={budget_pages}")
        self.pooled = (pool_ok and pool_fits) if cfg.paged_decode is None \
            else bool(cfg.paged_decode)
        # host-facing mirror appends are dense-layout: an int8 or MLA pool
        # (or SSM state rows) cannot absorb them, so the sequential
        # reference counts its mirror bytes but skips the tiered append
        # (generate() never mirrors when pooled)
        self._mirror_appends_ok = True
        if self.pooled:
            if self.desc.has_pages and cfg.max_len % cfg.page_tokens:
                raise ValueError(
                    f"pooled decode needs max_len ({cfg.max_len}) to be a "
                    f"multiple of page_tokens ({cfg.page_tokens})")
            self.tiered.init_pool(device=self.device)
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
        # of prefilling. Pooled path only: the mirror keeps sharing off
        self.prefix_cache = None
        if self.pooled and spec_cfg.prefix_cache_tokens > 0 \
                and self.desc.has_pages:
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

    def mirror_decode_batch(self, rids: list, cache, positions) -> None:
        """Mirror one decode step's tokens for a whole running batch: one
        on-device gather, ONE device→host transfer of ``(B, L, 2, K, D)``
        fp16, one batched ``append_many``. Bucket-ladder padding rows
        (``positions`` may be longer than ``rids``) are sliced off on
        device before the transfer: one fp16 token per real sequence."""
        if "k" not in cache or not rids:
            return
        toks = batching.gather_new_kv(
            cache["k"], cache["v"], positions)[:len(rids)].cpu()
        self.mirror_d2h_bytes += toks.numel() * toks.element_size()
        self.tiered.append_many(
            [(rid, toks[i]) for i, rid in enumerate(rids)])

    def _mirror_step_ragged(self, rids: list, cache, ctx, q_lens,
                            qmax: int, committed=None) -> None:
        """Mirror one fused mixed tick's new tokens: ONE on-device ragged
        gather, then at most three device→host transfers — the rows that
        committed one token (decode rows) as one fp16 token each, the
        chunk rows as one ``(n_chunk, Qmax, ...)`` block whose only
        padding is each chunk's own Qmax remainder, and each speculative
        row's accepted run (its rejected tail truncated on device, so it
        never reaches the mirror). A chunk row lands as one multi-token
        append, so ``kvhybrid`` still routes it by size; appends follow
        the batch's row order."""
        if "k" not in cache or not rids:
            return
        committed = (list(q_lens) if committed is None
                     else [int(c) for c in committed])
        toks_dev = batching.gather_new_kv_ragged(cache["k"], cache["v"],
                                                 ctx, qmax)
        dec = [i for i, m in enumerate(committed) if m == 1]
        chk = [i for i, m in enumerate(committed)
               if m > 1 and m == q_lens[i]]
        part = [i for i, m in enumerate(committed) if 1 < m < q_lens[i]]
        items = []
        if dec:
            toks1 = toks_dev[torch.tensor(dec, device=toks_dev.device),
                             0].cpu()                # (n_dec, L, 2, K, D)
            self.mirror_d2h_bytes += toks1.numel() * toks1.element_size()
            items += [(rids[i], toks1[j]) for j, i in enumerate(dec)]
        if chk:
            toksn = toks_dev[torch.tensor(chk, device=toks_dev.device)].cpu()
            self.mirror_d2h_bytes += toksn.numel() * toksn.element_size()
            items += [(rids[i], toksn[j, :q_lens[i]].permute(1, 2, 0, 3, 4))
                      for j, i in enumerate(chk)]
        for i in part:   # accepted run of a speculative row, tail dropped
            tk = toks_dev[i, :committed[i]].cpu()    # (accepted, L, 2, K, D)
            self.mirror_d2h_bytes += tk.numel() * tk.element_size()
            items.append((rids[i], tk.permute(1, 2, 0, 3, 4)))
        items.sort(key=lambda kv: rids.index(kv[0]))
        self.tiered.append_many(items)

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
        when chunked admission splits it) and land its KV in the tiered
        engine — scattered into pool pages on device (pooled), or mirrored
        as one batched append (dense mirror, the cache row kept on the
        device). ``tokens`` overrides the prompt (re-admission of a shed
        row). Returns (logits, cache row) for the scheduler."""
        src = req.prompt if tokens is None else tokens
        toks = src if n is None else src[:n]
        self.step_stats["prefill_calls"] += 1
        logits, cache = self._prefill(toks)
        self._count_logits(logits)
        self._count_moe()
        if self.pooled:
            return logits, self._pool_admit(req.rid, cache, toks.shape[0])
        self._mirror_prefill(req.rid, cache, toks.shape[0])
        return logits, cache

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
        row's cache to its position vector. The state-row family (SSM)
        commits the prompt-final state rows instead."""
        if n == 0:
            return {"pos": cache["pos"]}
        if not self.desc.has_pages:
            self.tiered.commit_state(
                [rid], [n], tuple(cache[p.name] for p in self.desc.seq_planes))
            return {"pos": cache["pos"]}
        phys = self.tiered.alloc_prefill(rid, n)
        pools = batching.scatter_prefill_planes(
            self.tiered.pool_views(),
            tuple(cache[p.name] for p in self.desc.paged_planes), phys, n)
        self.tiered.commit_prefill_planes(pools, rid, n)
        return {"pos": cache["pos"]}

    def _count_step(self, slots: int = 0, tokens: int = 0) -> None:
        """One model step; a ragged one adds its padded slots and its real
        tokens."""
        st = self.step_stats
        st["step_calls"] += 1
        st["step_slots"] += slots
        st["step_tokens"] += tokens

    def _count_logits(self, logits) -> None:
        self.step_stats["logit_bytes"] += logits.numel() * \
            logits.element_size()

    def _count_moe(self) -> None:
        """Add the last forward's drop-free MoE work (the model's
        ``moe_tally``, on the device) to the step counters: three adds on
        the device, no host read."""
        t = getattr(self.model, "moe_tally", None)
        if t is None:
            return
        self.model.moe_tally = None
        st = self.step_stats
        for i, key in enumerate(("expert_rows", "experts_run",
                                 "routed_slots")):
            st[key] = st[key] + t[i]

    def decode_batch(self, rids: list, caches: list, tokens: list,
                     mirrored: bool):
        """One batched single-token decode step (the unfused baseline's
        batched step). Pooled: the ragged step at ``q_len = 1``. Mirror:
        the dense ``decode_step`` over the concatenated rows (width padded
        up the power-of-two ladder with copies of row 0, whose outputs are
        dropped) plus one device→host transfer of one token per row.
        Returns (logits, new cache rows)."""
        if self.pooled:
            logit_rows, rows, _ = self.step_batch(
                rids, caches, [np.asarray([t], np.int32) for t in tokens],
                mirrored, fused=False)
            return torch.cat(logit_rows, dim=0), rows
        with telemetry.span(telemetry.PREPARE):
            B = len(caches)
            pad = batching.bucket_pow2(B) - B
            batch = batching.concat_rows(caches + [caches[0]] * pad)
            positions = batch["pos"]
            tok_arr = torch.tensor(list(tokens) + [0] * pad,
                                   device=self.device)[:, None]
        with telemetry.span(telemetry.FORWARD):
            self._count_step()
            logits, batch = self.model.decode_step(batch, tok_arr, positions,
                                                   n_valid=B)
            self._count_moe()
        with telemetry.span(telemetry.COMMIT):
            self.mirror_decode_batch(rids if mirrored else [], batch,
                                     positions)
            return logits[:B], [batching.split_row(batch, i)
                                for i in range(B)]

    def publish_plan(self, rids: list, n_tokens: list) -> int:
        """Scheduler lookahead: next tick's planned batch, forwarded to the
        async tiering pipeline (a no-op without one, and on the mirror)."""
        if not self.pooled:
            return 0
        return self.tiered.prefetch(rids, n_tokens)

    def can_step_fused(self, rids: list, n_tokens: list) -> bool:
        """Can this tick's mixed batch be placed in one fused step? The
        mirror always fits."""
        if not self.pooled:
            return True
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
        attend in the same step — over the device pool
        (``model.step_paged_ragged``) or over the dense rows
        (``model.step_ragged``, mirrored). Batch width and Qmax pad up the
        power-of-two ladder; padding rows ride with ``q_len = 0`` and are
        masked end to end.

        ``spec_lens[i]`` marks how many TRAILING tokens of ``tok_rows[i]``
        are unverified drafts: they scatter into the pool with the rest,
        are verified against this forward's own per-slot logits, and the
        rejected tail rolls back before anything else sees it (a partial
        commit: ``seq_len`` advances by the accepted count, pages only the
        tail used go back to the free list, and the next tick's lengths
        mask the stale slots until its writes overwrite them; on the
        mirror the tail's transfer is truncated and the row's ``pos``
        rewound, its dense KV masked past ``pos`` and overwritten by the
        row's next tokens).

        Returns ``(logit_rows, new_rows, committed)``: per-row logits for
        each row's committed slots (``(1, committed[i], V)`` — the LAST
        slot is what the next tick's argmax reads), the new per-row
        caches, and the per-row committed token counts."""
        B = len(rids)
        q_lens = [len(t) for t in tok_rows]
        spec = [0] * B if spec_lens is None else [int(s) for s in spec_lens]
        Bb = batching.bucket_pow2(B)
        Qb = batching.bucket_pow2(max(q_lens))
        if fused:       # the unfused pooled decode reuses this entry at
            self.step_stats["fused_steps"] += 1  # q_len=1; don't count it
        if not self.pooled:
            return self._mirror_step_batch(rids, caches, tok_rows, Bb, Qb,
                                           q_lens, spec, mirrored)
        if not self.desc.has_pages:
            return self._step_state_batch(rids, caches, tok_rows, Bb, Qb,
                                          q_lens, spec)
        names = [p.name for p in self.desc.paged_planes]
        # any exception between prepare_step and commit_step must rewind
        # the pages prepare_step allocated for this tick, or they leak
        try:
            with telemetry.span(telemetry.PREPARE):
                tokens, qarr = self._padded(tok_rows, Bb, Qb)
                tbl, ctx = self.tiered.prepare_step(rids, q_lens,
                                                    self.max_pages)
                model_pos = torch.cat([c["pos"] for c in caches]).cpu()
                if not np.array_equal(ctx, model_pos.numpy()):
                    raise RuntimeError(
                        f"pool/table drift: engine lengths {ctx.tolist()} "
                        f"!= model positions {model_pos.tolist()}")
                tbl_p = np.zeros((Bb, self.max_pages), np.int32)
                tbl_p[:B] = tbl
                ctx_p = np.zeros(Bb, np.int32)
                ctx_p[:B] = ctx
                cache = {"block_table":
                         torch.from_numpy(tbl_p).to(self.device)}
                for n, v in zip(names, self.tiered.pool_views()):
                    cache["pool_" + n] = v
                tokens, ctx_p, qarr = (torch.from_numpy(a).to(self.device)
                                       for a in (tokens, ctx_p, qarr))
            with telemetry.span(telemetry.FORWARD):
                self._count_step(Bb * Qb, sum(q_lens))
                logits, out = self.model.step_paged_ragged(
                    cache, tokens, ctx_p, qarr, n_valid=sum(q_lens))
                self._count_moe()
            with telemetry.span(telemetry.COMMIT):
                self._count_logits(logits)
                committed = self._verify_drafts(logits, tok_rows, q_lens,
                                                spec)
                # the step scattered in place into the engine's own
                # planes: handing them back stores the same tensors
                self.tiered.commit_step_planes(
                    tuple(out["pool_" + n] for n in names), rids, committed,
                    prepared=q_lens)
                # a row with rejected drafts rewinds its position on
                # device
                new_rows = [{"pos": out["pos"][i:i + 1]
                             - (q_lens[i] - committed[i])}
                            if committed[i] != q_lens[i]
                            else {"pos": out["pos"][i:i + 1]}
                            for i in range(B)]
                logit_rows = [logits[i:i + 1, :committed[i]]
                              for i in range(B)]
        except Exception:
            self.tiered.abort_step(rids)
            raise
        return logit_rows, new_rows, committed

    @staticmethod
    def _padded(tok_rows, Bb: int, Qb: int):
        """The step's ``(Bb, Qb)`` token array and ``(Bb,)`` q_lens, padding
        rows and slots zero."""
        tokens = np.zeros((Bb, Qb), np.int64)
        qarr = np.zeros(Bb, np.int32)
        for i, t in enumerate(tok_rows):
            tokens[i, :len(t)] = t
            qarr[i] = len(t)
        return tokens, qarr

    @staticmethod
    def _keep_slots(q_lens, spec, Bb: int, Qb: int):
        """The per-slot states a ragged SSM step keeps: a row commits slot
        ``q_len - 1`` without drafts, and one of its last ``1 + drafts``
        slots with them, so ``1 + max(drafts)`` slots a row suffice (the
        full stack would hold Qmax). Returns ``(keep_from, n_keep)``;
        padding rows keep none."""
        keep_from = [max(q - 1 - s, 0) for q, s in zip(q_lens, spec)]
        return keep_from + [Qb] * (Bb - len(q_lens)), 1 + max(spec)

    def _step_state_batch(self, rids, caches, tok_rows, Bb, Qb, q_lens,
                          spec):
        """:meth:`step_batch` for the state-row (SSM) family: the engine
        holds per-sequence state rows instead of pages, so the tick reads
        them back as a batch, runs the ragged state scan (keeping only the
        slots a row can commit) and commits each row's committed slot —
        committing an earlier slot IS the speculative rollback, and a
        padding row commits nothing. Zero device→host bytes, as on the
        paged pool."""
        B = len(rids)
        with telemetry.span(telemetry.PREPARE):
            tokens, qarr = self._padded(tok_rows, Bb, Qb)
            ctx = torch.cat([c["pos"] for c in caches]).cpu().numpy()
            eng_len = [int(self.tiered.seq_len.get(r, 0)) for r in rids]
            if eng_len != [int(c) for c in ctx]:
                raise RuntimeError(
                    f"state-row drift: engine lengths {eng_len} != model "
                    f"positions {ctx.tolist()}")
            ctx_p = np.zeros(Bb, np.int32)
            ctx_p[:B] = ctx
            # bucket-ladder padding rows replicate row 0's state: they
            # carry q_len = 0, so their outputs are discarded and nothing
            # commits
            views = self.tiered.state_views(list(rids)
                                            + [rids[0]] * (Bb - B))
            cache = {p.name: v for p, v in zip(self.desc.seq_planes, views)}
            keep_from, n_keep = self._keep_slots(q_lens, spec, Bb, Qb)
            tokens, ctx_p, qarr = (torch.from_numpy(a).to(self.device)
                                   for a in (tokens, ctx_p, qarr))
        with telemetry.span(telemetry.FORWARD):
            self._count_step(Bb * Qb, sum(q_lens))
            logits, out = self.model.step_paged_ragged(
                cache, tokens, ctx_p, qarr, keep=(keep_from, n_keep))
        with telemetry.span(telemetry.COMMIT):
            self._count_logits(logits)
            committed = self._verify_drafts(logits, tok_rows, q_lens, spec)
            states = []
            for j, p in enumerate(self.desc.seq_planes):
                steps = out[p.name + "_steps"]       # (L, n_keep, Bb, ...)
                states.append(torch.stack(
                    [steps[:, committed[i] - 1 - keep_from[i], i]
                     if committed[i] > 0 else views[j][:, i]
                     for i in range(B)], dim=1))
            self.tiered.commit_state(rids, committed, tuple(states))
            new_rows = [{"pos": torch.tensor([int(ctx[i]) + committed[i]],
                                             dtype=torch.int32,
                                             device=self.device)}
                        for i in range(B)]
            logit_rows = [logits[i:i + 1, :committed[i]] for i in range(B)]
            return logit_rows, new_rows, committed

    @staticmethod
    def _select_state_slots(batch: dict, committed: list, B: int,
                            keep_from: list) -> dict:
        """Mirror-path twin of the state commit: fold the ragged SSM step's
        kept per-slot states (``<plane>_steps``, ``(L, n_keep, Bb, ...)``)
        down to each row's committed slot before the batch splits back
        into rows. Rows with ``committed == 0`` keep the step's INPUT
        state; the ``_steps`` stacks never leave this method."""
        step_keys = [k for k in batch if k.endswith("_steps")]
        if not step_keys:
            return batch
        out = {k: v for k, v in batch.items() if k not in step_keys}
        for key in step_keys:
            name = key[:-len("_steps")]
            steps = batch[key]
            out[name] = torch.stack(
                [steps[:, committed[i] - 1 - keep_from[i], i]
                 if i < B and committed[i] > 0 else batch[name][:, i]
                 for i in range(steps.shape[2])], dim=1)
        return out

    def _mirror_step_batch(self, rids, caches, tok_rows, Bb, Qb, q_lens,
                           spec, mirrored):
        """:meth:`step_batch` on the dense mirror: the rows concatenate
        (padding rows are copies of row 0 that write nothing), one
        ``step_ragged`` runs over them, the new tokens are mirrored, an
        SSM row's committed slot state is selected, and the batch splits
        back into rows (views of the step's batch)."""
        B = len(rids)
        with telemetry.span(telemetry.PREPARE):
            tokens, qarr = self._padded(tok_rows, Bb, Qb)
            batch = batching.concat_rows(caches + [caches[0]] * (Bb - B))
            ctx = batch["pos"]
            keep = (self._keep_slots(q_lens, spec, Bb, Qb)
                    if self.desc.has_state else None)
            tokens, qarr = (torch.from_numpy(a).to(self.device)
                            for a in (tokens, qarr))
        with telemetry.span(telemetry.FORWARD):
            self._count_step(Bb * Qb, sum(q_lens))
            logits, nbatch = self.model.step_ragged(batch, tokens, ctx, qarr,
                                                    keep=keep,
                                                    n_valid=sum(q_lens))
            self._count_moe()
        with telemetry.span(telemetry.COMMIT):
            self._count_logits(logits)
            committed = self._verify_drafts(logits, tok_rows, q_lens, spec)
            if mirrored:
                self._mirror_step_ragged(rids, nbatch, ctx, q_lens, Qb,
                                         committed)
            if keep is not None:
                nbatch = self._select_state_slots(nbatch, committed, B,
                                                  keep[0])
            new_rows = [batching.split_row(nbatch, i) for i in range(B)]
            rewind = [i for i in range(B) if committed[i] != q_lens[i]]
            ctx_np = ctx.cpu().numpy() if rewind else None
            for i in rewind:
                # rewind past the rejected tail: its dense-cache KV is
                # masked (kv_pos > pos) and overwritten in place by the
                # row's next committed tokens
                new_rows[i]["pos"] = torch.tensor(
                    [int(ctx_np[i]) + committed[i]], dtype=torch.int32,
                    device=self.device)
            logit_rows = [logits[i:i + 1, :committed[i]] for i in range(B)]
            return logit_rows, new_rows, committed

    def extend_one(self, rid: int, cache, toks: np.ndarray, start: int,
                   mirrored: bool):
        """UNFUSED baseline (``fuse_ticks=False``): process ``toks``
        additional prompt tokens for one admitted row, each token through
        the single-token decode step at batch=1 — over the pool (page
        allocation per token, still zero device→host bytes), or over the
        row's dense cache with the chunk's KV mirrored as ONE batched
        append. Returns (logits, cache) positioned after the chunk."""
        logits = None
        if self.pooled and not self.desc.has_pages:
            # state-row family: check the rows out of the engine, run the
            # chunk through the decode step at batch=1, commit the final
            # state
            with telemetry.span(telemetry.PREPARE):
                views = self.tiered.state_views([rid])
                pc = {"pos": cache["pos"]}
                for p, v in zip(self.desc.seq_planes, views):
                    pc[p.name] = v
            with telemetry.span(telemetry.FORWARD):
                for t in toks:
                    self._count_step()
                    logits, pc = self.model.decode_step(
                        pc, torch.tensor([[int(t)]], device=self.device),
                        pc["pos"])
                    self._count_moe()
            with telemetry.span(telemetry.COMMIT):
                self.tiered.commit_state(
                    [rid], [len(toks)],
                    tuple(pc[p.name] for p in self.desc.seq_planes))
                return logits, {"pos": pc["pos"]}
        if not self.pooled:
            with telemetry.span(telemetry.FORWARD):
                for t in toks:
                    self._count_step()
                    logits, cache = self.model.decode_step(
                        cache, torch.tensor([[int(t)]], device=self.device),
                        cache["pos"])
                    self._count_moe()
            with telemetry.span(telemetry.COMMIT):
                if mirrored and len(toks):
                    kv = batching.gather_kv_range(
                        cache["k"], cache["v"], start,
                        start + len(toks)).cpu()
                    self.mirror_d2h_bytes += kv.numel() * kv.element_size()
                    self.tiered.append(rid, kv)
                return logits, cache
        names = [p.name for p in self.desc.paged_planes]
        for t in toks:
            with telemetry.span(telemetry.PREPARE):
                tbl, _ = self.tiered.prepare_decode([rid], self.max_pages)
                pc = {"pos": cache["pos"],
                      "block_table": torch.from_numpy(tbl).to(self.device)}
                for n, v in zip(names, self.tiered.pool_views()):
                    pc["pool_" + n] = v
            with telemetry.span(telemetry.FORWARD):
                self._count_step()
                logits, out = self.model.decode_step_paged(
                    pc, torch.tensor([[int(t)]], device=self.device),
                    cache["pos"])
                self._count_moe()
            with telemetry.span(telemetry.COMMIT):
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
        tiered append mirroring every token into the engine — ALWAYS, even
        on a pooled engine (dense pools only there; the int8 reference
        counts its mirror bytes, MLA has none)."""
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
        steps = {k: int(v) if isinstance(v, torch.Tensor) else v
                 for k, v in self.step_stats.items()}
        return {"sim_time_s": self.clock.now,
                "mirror_d2h_bytes": self.mirror_d2h_bytes,
                **steps, **self.spec_stats, **self.sched_stats,
                **journal, **self.tiered.stats}
