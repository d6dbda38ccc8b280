"""The LM of every family of the JAX package, as an ``nn.Module``.

The counterpart of the JAX package's ``LM`` for the decoder families
(``attn_dense``, ``moe``, ``ssm``, ``hybrid``), the VLM (``vlm``: a dense
decoder whose prompt is ``frontend_embeds`` image patches, projected by
the ``projector`` MLP, then the text) and the encoder-decoder (``encdec``:
``enc_blocks`` over ``frontend_embeds`` frames, ``enc_ln``, then
``blocks`` of enc-dec decoder layers — JAX's ``dec_blocks`` — with
cross-attention; a dense ``k``/``v`` cache and the cross K/V ``ek``/``ev``,
no cache descriptor: it serves nowhere, as in JAX), and their cache
families: GQA with a native cache, GQA with an int8 cache
(``kv_cache_dtype="int8"``; a MoE config keeps its native cache, as in
JAX), MLA (``cfg.mla``, the latent cache), Mamba-2 (``family="ssm"``: a
fixed-size ``conv``/``ssm`` state row per sequence, no KV) and Zamba2
(``family="hybrid"``: Mamba-2 layers in segments of
``shared_block_period``, each segment followed by a shared attention
block — ``seg_idx % num_shared_blocks`` — with the segment's own LoRA,
then a tail of the remaining Mamba-2 layers; no cache descriptor, so it
serves on the dense mirror, unfused). A MoE config runs
``cfg.moe.first_k_dense`` dense-FFN blocks, then MoE blocks (the JAX
package's ``dense_blocks`` and ``moe_blocks`` scans); layer ``i`` of the
stack is layer ``i`` of every cache plane.

* ``init(generator)`` — random weights with the reference's distributions;
* ``loss_fn(batch) -> (loss, metrics)`` — the training loss of every
  family under autograd (``remat``: each layer recomputed in the backward,
  as the reference's default policy; the parameters are frozen until
  :func:`repro_torch.training.init_train_state` turns their grad on);
* ``prefill(tokens, max_len, frontend_embeds=None) -> (logits, cache)``
  — dense padded cache (the SSM family: its final states; the hybrid: its
  segment, shared-KV and tail caches; the VLM and the encoder-decoder
  need ``frontend_embeds``, which the serving engine never passes, as the
  JAX engine never does);
* ``decode_step`` — one token over the dense cache (the sequential
  reference's step and the unfused dense-mirror path's batched step);
* ``step_ragged`` — one ragged mixed batch over the dense cache (the
  dense-mirror path's fused tick: plain torch attention, no kernel; the
  SSM family's per-slot state scan);
* ``decode_step_paged`` / ``step_paged_ragged`` — one token / one ragged
  mixed batch over the KV engine's device page pool, through the family's
  hand-written paged-attention kernel. The pool planes are named by the
  cache descriptor (``pool_<plane>`` in the cache dict). The SSM family
  has no pages: its ragged step runs over the engine's state rows.

Parameters are stored once in the compute dtype (the JAX package casts
every weight on every call, which is free inside ``jit`` but would copy
all weights every tick in eager torch). The layer stack is a Python loop
over an ``nn.ModuleList``; where the JAX scans return new pools, the
paged steps scatter in place into per-layer views of the engine's
``(L, P, T, *shape)`` planes and return those same tensors.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core.engines.desc import descriptor_for
from repro_torch.distributed.sharding import (folded_weight, replicated,
                                              settle_residual)
from repro_torch.models import blocks as B
from repro_torch.models.attention import quantize_kv
from repro_torch.models.layers import (cross_entropy_loss, embed,
                                       lm_logits, rmsnorm, truncated_normal_)


class LM(nn.Module):
    def __init__(self, cfg, *, dtype=torch.float32, device="cuda",
                 chunk_size: int = 512, kv_cache_dtype: str = "native",
                 remat: bool = True, ep_axes=()):
        super().__init__()
        if cfg.family not in ("attn_dense", "moe", "ssm", "hybrid", "vlm",
                              "encdec"):
            raise ValueError(f"unknown family {cfg.family!r}")
        if kv_cache_dtype not in ("native", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'native' or 'int8', "
                             f"got {kv_cache_dtype!r}")
        self.cfg = cfg
        # "int8": quantized KV cache with bf16 per-(token, head) scales
        # (dense GQA only: an MLA or MoE config keeps its native cache, as
        # in JAX)
        self.kv_cache_dtype = kv_cache_dtype
        self.device = resolve_device(device)
        self.dtype = dtype
        self.chunk_size = chunk_size
        # the loss path recomputes each layer (hybrid: each segment) in the
        # backward, as the reference's "nothing" remat policy does
        self.remat = remat
        # the mesh axes a MoE block's expert parallelism gathers over (the
        # data axes; the reference's ``build_model(ep_axes=...)``): with
        # DTensor weights on a mesh with a ``model`` axis the MoE blocks
        # take the EP paths
        self.ep_axes = tuple(ep_axes)
        V, d = cfg.padded_vocab, cfg.d_model
        self.embed = B.frozen_param((V, d), dtype, self.device)
        self.head = (None if cfg.tie_embeddings
                     else B.frozen_param((V, d), dtype, self.device))
        self.final_ln = B.frozen_param((d,), dtype, self.device, 1.0)
        if cfg.family in ("ssm", "hybrid"):
            # the hybrid's Mamba-2 layers in stack order: segment 0's
            # shared_block_period layers, segment 1's, ..., then the tail
            self.blocks = nn.ModuleList(
                B.SSMBlock(cfg, dtype, self.device)
                for _ in range(cfg.num_layers))
        elif cfg.family == "encdec":
            # the encoder layers are dense decoder layers run
            # bidirectionally; ``blocks`` are the decoder layers
            self.enc_blocks = nn.ModuleList(
                B.DecoderBlock(cfg, dtype, self.device, "dense")
                for _ in range(cfg.num_encoder_layers))
            self.enc_ln = B.frozen_param((d,), dtype, self.device, 1.0)
            self.blocks = nn.ModuleList(
                B.DecoderBlock(cfg, dtype, self.device, "encdec")
                for _ in range(cfg.num_layers))
        else:
            n_dense = (cfg.moe.first_k_dense if cfg.family == "moe"
                       else cfg.num_layers)
            self.blocks = nn.ModuleList(
                B.DecoderBlock(cfg, dtype, self.device,
                               "dense" if i < n_dense else "moe")
                for i in range(cfg.num_layers))
            for blk in self.blocks:
                blk.ep_axes = self.ep_axes
        if cfg.family == "hybrid":
            hy = cfg.hybrid
            self.n_seg = cfg.num_layers // hy.shared_block_period
            self.seg_len = hy.shared_block_period
            self.tail_len = cfg.num_layers - self.n_seg * self.seg_len
            self.shared_blocks = nn.ModuleList(
                B.DecoderBlock(cfg, dtype, self.device, "dense")
                for _ in range(hy.num_shared_blocks))
            self.loras = nn.ModuleList(
                B.LoRA(cfg, dtype, self.device) for _ in range(self.n_seg))
        if cfg.frontend.kind == "vision":
            fe = cfg.frontend
            self.projector = nn.ParameterList(
                B.frozen_param((fe.d_frontend if i == 0 else d, d), dtype,
                               self.device)
                for i in range(fe.projector_layers))
        # the cache planes by name, fixed by the descriptor: every step
        # reads this instead of asking the descriptor again (none for the
        # hybrid, which has no descriptor)
        desc = self.cache_descriptor()
        self.plane_names = (() if desc is None
                            else tuple(p.name for p in desc.paged_planes))
        self.cache_family = None if desc is None else desc.family

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> "LM":
        """Draw random weights in place from ``generator`` (on the model's
        device): the reference's truncated normals, ``std = 1/sqrt(fan_in)``
        with fan_in the first axis (the vocab, for the embedding tables)."""
        truncated_normal_(self.embed, 1.0, generator)
        if self.head is not None:
            truncated_normal_(self.head, 1.0, generator)
        self.final_ln.data.fill_(1.0)
        for blk in self.blocks:
            blk.init_weights(generator)
        if self.cfg.family == "hybrid":
            for blk in self.shared_blocks:
                blk.init_weights(generator)
            for lora in self.loras:
                lora.init_weights(generator)
        if self.cfg.family == "encdec":
            for blk in self.enc_blocks:
                blk.init_weights(generator)
            self.enc_ln.data.fill_(1.0)
        if self.cfg.frontend.kind == "vision":
            for w in self.projector:
                truncated_normal_(w, 1.0, generator)
        return self

    # ------------------------------------------------------------- helpers
    def _embed_tokens(self, tokens):
        h = embed(self.embed, tokens.to(self.device, torch.long),
                  self.cfg.embedding_scale)
        return h.to(self.dtype)

    def _project_frontend(self, embeds):
        """Image patches (B, n, d_frontend) → (B, n, d_model) through the
        projector MLP, tanh-GELU between its layers."""
        h = embeds.to(self.dtype)
        for i, w in enumerate(self.projector):
            if i:
                h = torch.nn.functional.gelu(h, approximate="tanh")
            h = h @ w
        return settle_residual(h, embeds)

    def _run_encoder(self, src):
        """The encoder stack over frames ``src`` (B, T, d_model) at
        positions ``arange(T)``, then ``enc_ln``."""
        Bz, T, _ = src.shape
        positions = torch.arange(T, device=self.device).expand(Bz, T)
        h = src.to(self.dtype)
        for blk in self.enc_blocks:
            h = self._call(lambda x, blk=blk: B.apply_encoder_block(
                blk, self.cfg, x, positions, chunk_size=self.chunk_size), h)
        # every decoder layer's cross K/V reads it: one settled gradient
        return settle_residual(rmsnorm(self.enc_ln, h, self.cfg.norm_eps), h)

    def _call(self, fn, *args):
        """``fn(*args)``: one layer (or hybrid segment) of a stack. On the
        loss path with ``remat`` it runs under activation checkpointing, so
        only its inputs are kept and the backward recomputes it."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(*args)

    def _logits(self, h, tokens):
        """fp32 logits of the final hidden state ``h``, laid out (on a
        mesh) as the batch's ``tokens``: batch-sharded, replicated on the
        other mesh dims, so the vocab-sharded table gives vocab-sharded
        logits (where the batch is folded over ``model``, the table is
        gathered there: :func:`~repro_torch.distributed.sharding.
        folded_weight`)."""
        cfg = self.cfg
        h = rmsnorm(self.final_ln, settle_residual(h, tokens), cfg.norm_eps)
        h = settle_residual(h, tokens)        # the head's gradient
        table = folded_weight(self.embed if cfg.tie_embeddings
                              else self.head, h)
        return lm_logits(table, h, cfg.logit_scale, cfg.logit_soft_cap,
                         vocab_size=cfg.vocab_size)

    def cache_descriptor(self, page_tokens: int = 16):
        """This model's cache descriptor — dense ``(k, v)`` or MLA
        ``(c, kr)`` in the compute dtype, int8 ``(k, v)`` with bf16
        ``(k_scale, v_scale)``, or the SSM family's ``conv``/``ssm`` state
        rows — the layout the pooled serving path allocates; None for the
        hybrid (mirror only, as in JAX)."""
        return descriptor_for(self.cfg, self.kv_cache_dtype, self.dtype,
                              page_tokens)

    def supports_ragged_step(self) -> bool:
        return self.cache_descriptor() is not None

    # ---------------------------------------------------------------- train
    def loss_fn(self, batch):
        """The training loss of ``batch``, a dict of arrays: ``tokens`` and
        ``labels`` (B, S), optional ``loss_mask`` (B, S) and, for the VLM and
        the encoder-decoder, ``frontend_embeds`` (image patches before the
        text; audio frames for the encoder). Returns ``(loss, {"loss",
        "aux_loss"})``: the mean next-token NLL over the mask (the VLM's on
        its text positions only), plus ``router_aux_weight · aux`` for a MoE
        config, ``aux`` the load-balancing losses summed over its layers.
        The reference's ``LM.loss_fn``, run under autograd: the parameters
        must require grad (``training.init_train_state`` turns that on)."""
        cfg, dev, cs = self.cfg, self.device, self.chunk_size
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        Bz, S = tokens.shape
        h = self._embed_tokens(tokens)
        positions = torch.arange(S, device=dev).expand(Bz, S)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        fam = cfg.family
        if fam in ("attn_dense", "moe", "vlm"):
            n_img = 0
            if fam == "vlm":
                img = self._project_frontend(torch.as_tensor(
                    batch["frontend_embeds"], device=dev))
                n_img = img.shape[1]
                h = torch.cat([img, h], 1)
                positions = torch.arange(n_img + S, device=dev).expand(
                    Bz, n_img + S)
            for blk in self.blocks:
                h, a = self._call(lambda x, blk=blk: B.train_decoder_block(
                    blk, cfg, x, positions, chunk_size=cs), h)
                # on a mesh the EP aux loss is the data shards' mean:
                # summed here, once a layer (left Partial, torch 2.11 and
                # 2.13 sum it at different ops)
                aux = aux + replicated(a)
            h = h[:, n_img:]
        elif fam == "ssm":
            for blk in self.blocks:
                h = self._call(lambda x, blk=blk: B.apply_ssm_block(
                    blk, cfg, x)[0], h)
        elif fam == "hybrid":
            h = self._hybrid_loss_stack(h, positions)
        else:                                               # encdec
            enc_out = self._run_encoder(torch.as_tensor(
                batch["frontend_embeds"], device=dev))

            def dec_body(x, enc, blk):
                ek, ev = B.cross_kv(blk, cfg, enc)
                return B.apply_encdec_decoder_block(
                    blk, cfg, x, positions, ek, ev, chunk_size=cs)[0]
            for blk in self.blocks:
                h = self._call(lambda x, e, blk=blk: dec_body(x, e, blk), h,
                               enc_out)
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=dev)
        loss = cross_entropy_loss(self._logits(h, tokens), labels, mask)
        if cfg.moe is not None:
            loss = loss + cfg.moe.router_aux_weight * aux
        return loss, {"loss": loss, "aux_loss": aux}

    def _hybrid_loss_stack(self, h, positions):
        """Zamba2 on the loss path: each segment (its Mamba-2 layers, then
        its shared block with its LoRA) one checkpointed call, as the
        reference remats its segment scan body; then the tail layers."""
        cfg = self.cfg

        def seg_body(x, blocks, shared, lora):
            for blk in blocks:
                x = B.apply_ssm_block(blk, cfg, x)[0]
            return B.apply_shared_block(shared, lora, cfg, x, positions,
                                        chunk_size=self.chunk_size)[0]
        layers = iter(self.blocks)
        for seg in range(self.n_seg):
            blocks = [next(layers) for _ in range(self.seg_len)]
            shared = self.shared_blocks[seg % cfg.hybrid.num_shared_blocks]
            h = self._call(lambda x, b=blocks, s=shared, lo=self.loras[seg]:
                           seg_body(x, b, s, lo), h)
        for blk in layers:
            h = self._call(lambda x, blk=blk: B.apply_ssm_block(
                blk, cfg, x)[0], h)
        return h

    # -------------------------------------------------------------- prefill
    @staticmethod
    def _pad_stack(parts, S, T):
        """Stack per-layer ``(B, S, *shape)`` arrays into one ``(n, B, T,
        *shape)`` array, zero past ``S``: a concatenation, so a DTensor
        keeps its placements (its ``new_zeros`` would be whole on every
        rank)."""
        x = torch.stack(parts)
        if T > S:
            pad = torch.zeros_like(x[:, :, :1]).expand(
                x.shape[:2] + (T - S,) + x.shape[3:])
            x = torch.cat([x, pad], dim=2)
        return x

    @torch.no_grad()
    def prefill(self, tokens, max_len: int, frontend_embeds=None):
        """Run the prompt ``tokens`` (B, S); return the last position's
        logits (B, 1, V) fp32 and the decode cache: ``pos`` (B,) int32 and
        one ``(L, B, max(max_len, S), *shape)`` array per descriptor plane,
        zero past S — ``k``/``v``; int8 ``k``/``v`` with ``k_scale``/
        ``v_scale`` (the padded cache quantized, as in JAX); or MLA
        ``c``/``kr``. The SSM family returns its final states, ``conv``
        ``(L, B, d_conv-1, conv_dim)`` and ``ssm`` ``(L, B, H, P, N)`` fp32;
        the hybrid ``seg_conv``/``seg_ssm`` ``(n_seg, seg_len, B, ...)``,
        ``shared_k``/``shared_v`` ``(n_seg, B, T, K, D)`` and, with a
        tail, ``tail_conv``/``tail_ssm`` ``(tail, B, ...)``.

        ``frontend_embeds`` is what the VLM and the encoder-decoder need
        (the other families ignore it, as in JAX): the VLM's image patches
        (B, n_img, d_frontend) go before the text, at positions
        ``arange(n_img + S)`` with ``pos = n_img + S``, and its cache is
        ``max(max_len, n_img + S)`` long (never cut); the encoder-decoder's
        frames (B, T_enc, d_model) run the encoder, and its cache adds the
        cross-attention K/V ``ek``/``ev`` (L, B, T_enc, K, D)."""
        cfg = self.cfg
        if cfg.family in ("vlm", "encdec"):
            if frontend_embeds is None:
                raise ValueError(f"family {cfg.family!r} needs "
                                 f"frontend_embeds (image patches or audio "
                                 f"frames) beside the tokens")
            frontend_embeds = torch.as_tensor(frontend_embeds,
                                              device=self.device)
        tokens = torch.as_tensor(tokens, device=self.device)
        Bz, S = tokens.shape
        h = self._embed_tokens(tokens)
        if cfg.family == "vlm":
            h = torch.cat([self._project_frontend(frontend_embeds), h], 1)
            S = h.shape[1]                  # image tokens, then the text
        positions = torch.arange(S, device=self.device).expand(Bz, S)
        cache = {"pos": torch.full((Bz,), S, dtype=torch.int32,
                                   device=self.device)}
        T = max(max_len, S)
        if cfg.family == "encdec":
            enc_out = self._run_encoder(frontend_embeds)
            kv, cross = ([], []), ([], [])
            for blk in self.blocks:
                ek_ev = B.cross_kv(blk, cfg, enc_out)
                h, pair = B.apply_encdec_decoder_block(
                    blk, cfg, h, positions, *ek_ev,
                    chunk_size=self.chunk_size)
                for acc, x in zip(kv + cross, pair + ek_ev):
                    acc.append(x)
            cache["k"], cache["v"] = (self._pad_stack(a, S, T) for a in kv)
            cache["ek"], cache["ev"] = (torch.stack(a) for a in cross)
            return self._logits(h[:, -1:], tokens), cache
        if cfg.family == "ssm":
            states = [], []
            for blk in self.blocks:
                h, st = B.apply_ssm_block(blk, cfg, h)
                for acc, x in zip(states, st):
                    acc.append(x)
            cache["conv"], cache["ssm"] = (torch.stack(a) for a in states)
            return self._logits(h[:, -1:], tokens), cache
        if cfg.family == "hybrid":
            h, cache_parts = self._run_hybrid_stack(h, positions)
            seg, kv, tail = cache_parts
            n, m = self.n_seg, self.seg_len
            for name, acc in zip(("seg_conv", "seg_ssm"), seg):
                x = torch.stack(acc)
                cache[name] = x.reshape((n, m) + x.shape[1:])
            cache["shared_k"], cache["shared_v"] = (
                self._pad_stack(acc, S, T) for acc in kv)
            if self.tail_len:
                cache["tail_conv"], cache["tail_ssm"] = (
                    torch.stack(acc) for acc in tail)
            return self._logits(h[:, -1:], tokens), cache
        parts = ([], [])
        for blk in self.blocks:
            h, kv = B.apply_decoder_block(blk, cfg, h, positions,
                                          chunk_size=self.chunk_size)
            for acc, x in zip(parts, kv):
                acc.append(x)
        padded = [self._pad_stack(acc, S, T) for acc in parts]
        if cfg.mla is not None:
            cache["c"], cache["kr"] = padded
        elif self.cache_family == "int8":
            cache["k"], cache["k_scale"] = quantize_kv(padded[0])
            cache["v"], cache["v_scale"] = quantize_kv(padded[1])
        else:
            cache["k"], cache["v"] = padded
        return self._logits(h[:, -1:], tokens), cache

    def _run_hybrid_stack(self, h, positions):
        """Zamba2's full-sequence stack: ``n_seg`` × (``seg_len`` Mamba-2
        layers, then shared block ``seg % num_shared_blocks`` with LoRA
        ``seg``), then the tail. Returns ``h`` and the per-layer caches:
        segment states, shared-block K/V, tail states (lists)."""
        cfg = self.cfg
        seg_states, kv, tail_states = ([], []), ([], []), ([], [])
        layers = iter(self.blocks)
        for seg in range(self.n_seg):
            for _ in range(self.seg_len):
                h, st = B.apply_ssm_block(next(layers), cfg, h)
                for acc, x in zip(seg_states, st):
                    acc.append(x)
            shared = self.shared_blocks[seg % cfg.hybrid.num_shared_blocks]
            h, pair = B.apply_shared_block(shared, self.loras[seg], cfg, h,
                                           positions,
                                           chunk_size=self.chunk_size)
            for acc, x in zip(kv, pair):
                acc.append(x)
        for blk in layers:
            h, st = B.apply_ssm_block(blk, cfg, h)
            for acc, x in zip(tail_states, st):
                acc.append(x)
        return h, (seg_states, kv, tail_states)

    # --------------------------------------------------------- decode steps
    @torch.no_grad()
    def decode_step(self, cache, tokens, positions):
        """One token per row over the dense cache (KV written in place; the
        SSM states of the ``ssm`` and ``hybrid`` families come back as new
        tensors; the encoder-decoder reads its cross K/V ``ek``/``ev``).
        tokens: (B, 1); positions: (B,) write/query index."""
        cfg = self.cfg
        h = self._embed_tokens(tokens)
        positions = positions.to(self.device, torch.long)
        new_cache = dict(cache)
        new_cache["pos"] = (positions + 1).to(torch.int32)
        if cfg.family == "ssm":
            h, new_cache["conv"], new_cache["ssm"] = self._decode_ssm_layers(
                self.blocks, h, cache["conv"], cache["ssm"])
        elif cfg.family == "hybrid":
            h = self._decode_hybrid(h, cache, new_cache, positions)
        elif cfg.family == "encdec":
            for i, blk in enumerate(self.blocks):
                h, _ = B.decode_encdec_decoder_block(
                    blk, cfg, h, tuple(cache[n][i] for n in
                                       ("k", "v", "ek", "ev")), positions)
        else:
            names = self.plane_names
            for i, blk in enumerate(self.blocks):
                h, _ = B.decode_decoder_block(
                    blk, cfg, h, tuple(cache[n][i] for n in names),
                    positions)
        return self._logits(h, tokens), new_cache

    def _decode_ssm_layers(self, blocks, h, conv, ssm):
        """Single-token SSM blocks over per-layer states ``conv[i]``/
        ``ssm[i]``; returns ``h`` and the stacked new states."""
        new = [], []
        for i, blk in enumerate(blocks):
            h, nc, ns = B.decode_ssm_block(blk, self.cfg, h, conv[i], ssm[i])
            new[0].append(nc)
            new[1].append(ns)
        return h, torch.stack(new[0]), torch.stack(new[1])

    def _decode_hybrid(self, h, cache, new_cache, positions):
        """Zamba2's single-token stack: each segment's Mamba-2 layers, then
        its shared block over ``shared_k[seg]``/``shared_v[seg]`` (written
        in place), then the tail. Fills ``new_cache``; returns ``h``."""
        cfg = self.cfg
        n, m = self.n_seg, self.seg_len
        convs, ssms = [], []
        for seg in range(n):
            h, nc, ns = self._decode_ssm_layers(
                self.blocks[seg * m:(seg + 1) * m], h, cache["seg_conv"][seg],
                cache["seg_ssm"][seg])
            convs.append(nc)
            ssms.append(ns)
            shared = self.shared_blocks[seg % cfg.hybrid.num_shared_blocks]
            h, _ = B.decode_shared_block(
                shared, self.loras[seg], cfg, h,
                (cache["shared_k"][seg], cache["shared_v"][seg]), positions)
        new_cache["seg_conv"] = torch.stack(convs)
        new_cache["seg_ssm"] = torch.stack(ssms)
        if self.tail_len:
            h, new_cache["tail_conv"], new_cache["tail_ssm"] = \
                self._decode_ssm_layers(self.blocks[n * m:], h,
                                        cache["tail_conv"], cache["tail_ssm"])
        return h

    def _step_ragged_ssm(self, cache, tokens, ctx_lens, q_lens, keep):
        """Ragged multi-token SSM step: each layer scans its single-step
        mixer over the Qmax slots (state updates masked past ``q_lens``)
        and emits per-slot states ``conv_steps``/``ssm_steps`` shaped
        ``(L, Qmax, B, ...)`` — slot ``i`` the state after token ``i`` —
        or, with ``keep = (keep_from, n_keep)``, only the slots a row can
        commit, ``(L, n_keep, B, ...)`` (see
        :func:`~repro_torch.models.blocks.step_ragged_ssm_block`). The
        serving engine commits each row's committed slot (an earlier slot
        is the speculative rollback); ``cache["conv"]``/``cache["ssm"]``
        stay the step's input states."""
        h = self._embed_tokens(tokens)
        conv_steps, ssm_steps = [], []
        for i, blk in enumerate(self.blocks):
            h, cs, ss = B.step_ragged_ssm_block(
                blk, self.cfg, h, cache["conv"][i], cache["ssm"][i], q_lens,
                keep)
            conv_steps.append(cs)
            ssm_steps.append(ss)
        new_cache = dict(cache)
        new_cache["pos"] = (ctx_lens + q_lens).to(torch.int32)
        new_cache["conv_steps"] = torch.stack(conv_steps)
        new_cache["ssm_steps"] = torch.stack(ssm_steps)
        return self._logits(h, tokens), new_cache

    def _ragged_desc(self, what: str):
        desc = self.cache_descriptor()
        if desc is None:
            raise ValueError(
                f"no cache descriptor for family={self.cfg.family!r} "
                f"kv_cache_dtype={self.kv_cache_dtype!r}; {what} needs a "
                f"pooled layout")
        return desc

    @torch.no_grad()
    def step_ragged(self, cache, tokens, ctx_lens, q_lens, keep=None):
        """One fused mixed-batch step over the dense padded cache planes
        (``(L, B, T, *shape)`` in descriptor order, written in place).
        tokens: (B, Qmax) — row ``b``'s ``q_lens[b]`` new tokens at
        positions ``ctx_lens[b] + i`` (0 marks padding rows). Returns
        logits for every slot (B, Qmax, V) and the cache with
        ``pos = ctx_lens + q_lens``. With every ``q_len == 1`` this is
        :meth:`decode_step` op for op. The SSM family runs the per-slot
        state scan over ``cache["conv"]``/``cache["ssm"]`` (``keep``:
        see :meth:`_step_ragged_ssm`)."""
        desc = self._ragged_desc("ragged step")
        ctx_lens = ctx_lens.to(self.device, torch.long)
        q_lens = q_lens.to(self.device, torch.long)
        if not desc.has_pages:
            return self._step_ragged_ssm(cache, tokens, ctx_lens, q_lens,
                                         keep)
        h = self._embed_tokens(tokens)
        names = self.plane_names
        for i, blk in enumerate(self.blocks):
            h, _ = B.step_ragged_block(
                blk, self.cfg, h, tuple(cache[n][i] for n in names),
                ctx_lens, q_lens)
        new_cache = dict(cache)
        new_cache["pos"] = (ctx_lens + q_lens).to(torch.int32)
        return self._logits(h, tokens), new_cache

    def _paged_layers(self, cache, h, step):
        """Run the layer stack over per-layer views of the cache's
        ``pool_<plane>`` planes; returns ``h`` and the (updated in place)
        planes by name."""
        pools = {n: cache["pool_" + n] for n in self.plane_names}
        for i, blk in enumerate(self.blocks):
            h, _ = step(blk, h, tuple(p[i] for p in pools.values()))
        return h, {"pool_" + n: p for n, p in pools.items()}

    @torch.no_grad()
    def decode_step_paged(self, cache, tokens, positions):
        """One token per row over the device page pool. cache: ``pos``,
        one ``pool_<plane>`` (L, P, T, *shape) per descriptor plane and
        ``block_table`` (B, MP) int32. Returns logits (B, 1, V) and the
        cache with ``pos + 1`` and the same (updated in place) pool
        tensors."""
        cfg, table = self.cfg, cache["block_table"]
        positions = positions.to(self.device, torch.long)
        h, pools = self._paged_layers(
            cache, self._embed_tokens(tokens),
            lambda blk, hh, planes: B.decode_paged_block(
                blk, cfg, hh, planes, table, positions))
        new_cache = {"pos": (positions + 1).to(torch.int32),
                     "block_table": table, **pools}
        return self._logits(h, tokens), new_cache

    @torch.no_grad()
    def step_paged_ragged(self, cache, tokens, ctx_lens, q_lens, keep=None):
        """One fused mixed-batch step over the device page pool. tokens:
        (B, Qmax) — row ``b``'s ``q_lens[b]`` new tokens (0 marks padding
        rows); ctx_lens: (B,) tokens already pooled. Returns logits for
        every slot (B, Qmax, V) — callers read slot ``q_lens[b] - 1`` —
        and the cache with ``pos = ctx_lens + q_lens``. The SSM family has
        no pages: its cache is the engine's ``conv``/``ssm`` state rows
        (``(L, B, ...)``) and the step is :meth:`_step_ragged_ssm`."""
        desc = self._ragged_desc("ragged paged step")
        ctx_lens = ctx_lens.to(self.device, torch.long)
        q_lens = q_lens.to(self.device, torch.long)
        if not desc.has_pages:
            return self._step_ragged_ssm(cache, tokens, ctx_lens, q_lens,
                                         keep)
        cfg, table = self.cfg, cache["block_table"]
        h, pools = self._paged_layers(
            cache, self._embed_tokens(tokens),
            lambda blk, hh, planes: B.step_paged_ragged_block(
                blk, cfg, hh, planes, table, ctx_lens, q_lens))
        new_cache = {"pos": (ctx_lens + q_lens).to(torch.int32),
                     "block_table": table, **pools}
        return self._logits(h, tokens), new_cache


def _jax_layers(cfg) -> list:
    """Every stacked layer of the JAX package's ``LM.init`` pytree, in the
    port's module order: ``(port prefix, JAX stack, index, kind)``. The
    stack is the pytree key whose leaves carry the layer axis (for the
    hybrid's ``mamba_seg`` two: ``index`` is then ``(segment, layer)``);
    ``kind`` is a block's ``ffn_kind`` (``"dense"``, ``"moe"``,
    ``"encdec"``), ``"ssm"`` or ``"lora"``."""
    fam = cfg.family
    if fam == "encdec":
        return ([(f"enc_blocks.{j}", "enc_blocks", j, "dense")
                 for j in range(cfg.num_encoder_layers)]
                + [(f"blocks.{j}", "dec_blocks", j, "encdec")
                   for j in range(cfg.num_layers)])
    if fam == "ssm":
        return [(f"blocks.{i}", "blocks", i, "ssm")
                for i in range(cfg.num_layers)]
    if fam == "hybrid":
        hy = cfg.hybrid
        n_seg = cfg.num_layers // hy.shared_block_period
        layers = [("mamba_seg", (s, i)) for s in range(n_seg)
                  for i in range(hy.shared_block_period)]
        layers += [("mamba_tail", i)
                   for i in range(cfg.num_layers - len(layers))]
        return ([(f"blocks.{j}", stack, index, "ssm")
                 for j, (stack, index) in enumerate(layers)]
                + [(f"shared_blocks.{j}", "shared_blocks", j, "dense")
                   for j in range(hy.num_shared_blocks)]
                + [(f"loras.{s}", "loras", s, "lora") for s in range(n_seg)])
    if fam == "moe":
        n_dense = cfg.moe.first_k_dense
        layers = [("dense_blocks", i, "dense") for i in range(n_dense)]
        layers += [("moe_blocks", i, "moe")
                   for i in range(cfg.num_layers - n_dense)]
    else:
        layers = [("blocks", i, "dense") for i in range(cfg.num_layers)]
    return [(f"blocks.{j}", stack, i, kind)
            for j, (stack, i, kind) in enumerate(layers)]


def _jax_layer_arrays(np_params: dict, cfg, stack, index, kind) -> dict:
    if kind == "ssm":
        return B.ssm_block_arrays(np_params[stack], index)
    if kind == "lora":
        return {n: np_params[stack][n][index] for n in ("a", "b")}
    return B.jax_block_arrays(np_params[stack], index, cfg, kind)


def params_from_jax(np_params: dict, cfg) -> dict:
    """A state dict for :class:`LM` from the JAX package's ``LM.init``
    pytree as numpy arrays (``jax.tree.map(np.asarray, params)``; a
    gradient pytree of the same structure maps alike). The stacked
    ``params["blocks"]`` (leading L axis) — for a MoE config
    ``params["dense_blocks"]`` then ``params["moe_blocks"]``; for the
    hybrid ``params["mamba_seg"]`` (leading ``(n_seg, seg_len)``) then
    ``params["mamba_tail"]``, with ``shared_blocks`` and ``loras``; for the
    encoder-decoder ``params["enc_blocks"]`` and ``params["dec_blocks"]``
    (the port's ``blocks``) with ``enc_ln`` — split into the
    ``ModuleList``s (:func:`_jax_layers`); matrices keep the ``(d_in,
    d_out)`` layout (the experts their stacked ``(E, d_in, d_out)``), as do
    the VLM's ``projector`` matrices. A tied config has no ``head``."""
    sd = {"embed": np_params["embed"]["table"],
          "final_ln": np_params["final_ln"]["scale"]}
    if not cfg.tie_embeddings:
        sd["head"] = np_params["head"]["table"]
    for i, w in enumerate(np_params.get("projector", ())):
        sd[f"projector.{i}"] = w
    if cfg.family == "encdec":
        sd["enc_ln"] = np_params["enc_ln"]["scale"]
    for prefix, stack, index, kind in _jax_layers(cfg):
        for name, arr in _jax_layer_arrays(np_params, cfg, stack, index,
                                           kind).items():
            sd[f"{prefix}.{name}"] = arr
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in sd.items()}


def jax_leaf_ndims(model: LM) -> dict:
    """Parameter name → the rank of the JAX leaf it comes from: its own
    rank plus the layer axes its JAX stack carries (:func:`_jax_layers`:
    one, two for the hybrid's ``mamba_seg``); a top-level leaf
    (``embed``, ``final_ln``, a projector matrix) has no such axis. The
    reference's AdamW decays a leaf of rank 2 or more, so this decides
    which of the port's per-layer tensors decay: every block's norm scales
    do, the top-level ``final_ln`` and ``enc_ln`` do not."""
    axes = {prefix: len(index) if isinstance(index, tuple) else 1
            for prefix, _, index, _ in _jax_layers(model.cfg)}
    return {name: p.ndim + axes.get(".".join(name.split(".")[:2]), 0)
            for name, p in model.named_parameters()}
