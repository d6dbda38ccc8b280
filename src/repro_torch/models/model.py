"""Decoder-only LM for ``family="attn_dense"`` and ``family="moe"``, as an
``nn.Module``.

The counterpart of the JAX package's ``LM`` for the decoder families and
their three cache families: GQA with a native cache, GQA with an int8
cache (``kv_cache_dtype="int8"``; a MoE config keeps its native cache, as
in JAX), and MLA (``cfg.mla``, the latent cache). A MoE config runs
``cfg.moe.first_k_dense`` dense-FFN blocks, then MoE blocks (the JAX
package's ``dense_blocks`` and ``moe_blocks`` scans); layer ``i`` of the
stack is layer ``i`` of every cache plane.

* ``init(generator)`` — random weights with the reference's distributions;
* ``prefill(tokens, max_len) -> (logits, cache)`` — dense padded cache;
* ``decode_step`` — one token over the dense cache (the sequential
  reference's step and the unfused dense-mirror path's batched step);
* ``step_ragged`` — one ragged mixed batch over the dense cache (the
  dense-mirror path's fused tick: plain torch attention, no kernel);
* ``decode_step_paged`` / ``step_paged_ragged`` — one token / one ragged
  mixed batch over the KV engine's device page pool, through the family's
  hand-written paged-attention kernel. The pool planes are named by the
  cache descriptor (``pool_<plane>`` in the cache dict).

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

from repro_torch import resolve_device
from repro_torch.core.engines.desc import descriptor_for
from repro_torch.models import blocks as B
from repro_torch.models.attention import quantize_kv
from repro_torch.models.layers import (embed, lm_logits, rmsnorm,
                                       truncated_normal_)


class LM(nn.Module):
    def __init__(self, cfg, *, dtype=torch.float32, device="cuda",
                 chunk_size: int = 512, kv_cache_dtype: str = "native"):
        super().__init__()
        if cfg.family not in ("attn_dense", "moe"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP.md, "
                f"queue 1: modules to port)")
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
        V, d = cfg.padded_vocab, cfg.d_model
        self.embed = B.frozen_param((V, d), dtype, self.device)
        self.head = (None if cfg.tie_embeddings
                     else B.frozen_param((V, d), dtype, self.device))
        self.final_ln = B.frozen_param((d,), dtype, self.device, 1.0)
        n_dense = (cfg.moe.first_k_dense if cfg.family == "moe"
                   else cfg.num_layers)
        self.blocks = nn.ModuleList(
            B.DecoderBlock(cfg, dtype, self.device,
                           "dense" if i < n_dense else "moe")
            for i in range(cfg.num_layers))
        # the cache planes by name, fixed by the descriptor: every step
        # reads this instead of asking the descriptor again
        desc = self.cache_descriptor()
        self.plane_names = tuple(p.name for p in desc.paged_planes)
        self.cache_family = desc.family

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
        return self

    # ------------------------------------------------------------- helpers
    def _embed_tokens(self, tokens):
        h = embed(self.embed, tokens.to(self.device, torch.long),
                  self.cfg.embedding_scale)
        return h.to(self.dtype)

    def _logits(self, h):
        cfg = self.cfg
        h = rmsnorm(self.final_ln, h, cfg.norm_eps)
        table = self.embed if cfg.tie_embeddings else self.head
        return lm_logits(table, h, cfg.logit_scale, cfg.logit_soft_cap,
                         vocab_size=cfg.vocab_size)

    def cache_descriptor(self, page_tokens: int = 16):
        """This model's cache descriptor — dense ``(k, v)`` or MLA
        ``(c, kr)`` in the compute dtype, or int8 ``(k, v)`` with bf16
        ``(k_scale, v_scale)`` — the plane layout the pooled serving path
        allocates."""
        return descriptor_for(self.cfg, self.kv_cache_dtype, self.dtype,
                              page_tokens)

    def supports_ragged_step(self) -> bool:
        return self.cache_descriptor() is not None

    # -------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, tokens, max_len: int):
        """Run the prompt ``tokens`` (B, S); return the last position's
        logits (B, 1, V) fp32 and the decode cache: ``pos`` (B,) int32 and
        one ``(L, B, max(max_len, S), *shape)`` array per descriptor plane,
        zero past S — ``k``/``v``; int8 ``k``/``v`` with ``k_scale``/
        ``v_scale`` (the padded cache quantized, as in JAX); or MLA
        ``c``/``kr``."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device)
        Bz, S = tokens.shape
        h = self._embed_tokens(tokens)
        positions = torch.arange(S, device=self.device).expand(Bz, S)
        parts = ([], [])
        for blk in self.blocks:
            h, kv = B.apply_decoder_block(blk, cfg, h, positions,
                                          chunk_size=self.chunk_size)
            for acc, x in zip(parts, kv):
                acc.append(x)
        T = max(max_len, S)
        padded = []
        for acc in parts:
            x = torch.zeros((cfg.num_layers, Bz, T) + acc[0].shape[2:],
                            dtype=acc[0].dtype, device=self.device)
            x[:, :, :S] = torch.stack(acc)
            padded.append(x)
        cache = {"pos": torch.full((Bz,), S, dtype=torch.int32,
                                   device=self.device)}
        if cfg.mla is not None:
            cache["c"], cache["kr"] = padded
        elif self.cache_family == "int8":
            cache["k"], cache["k_scale"] = quantize_kv(padded[0])
            cache["v"], cache["v_scale"] = quantize_kv(padded[1])
        else:
            cache["k"], cache["v"] = padded
        return self._logits(h[:, -1:]), cache

    # --------------------------------------------------------- decode steps
    @torch.no_grad()
    def decode_step(self, cache, tokens, positions):
        """One token per row over the dense cache (written in place).
        tokens: (B, 1); positions: (B,) write/query index."""
        h = self._embed_tokens(tokens)
        positions = positions.to(self.device, torch.long)
        names = self.plane_names
        for i, blk in enumerate(self.blocks):
            h, _ = B.decode_decoder_block(
                blk, self.cfg, h, tuple(cache[n][i] for n in names),
                positions)
        new_cache = dict(cache)
        new_cache["pos"] = (positions + 1).to(torch.int32)
        return self._logits(h), new_cache

    @torch.no_grad()
    def step_ragged(self, cache, tokens, ctx_lens, q_lens):
        """One fused mixed-batch step over the dense padded cache planes
        (``(L, B, T, *shape)`` in descriptor order, written in place).
        tokens: (B, Qmax) — row ``b``'s ``q_lens[b]`` new tokens at
        positions ``ctx_lens[b] + i`` (0 marks padding rows). Returns
        logits for every slot (B, Qmax, V) and the cache with
        ``pos = ctx_lens + q_lens``. With every ``q_len == 1`` this is
        :meth:`decode_step` op for op."""
        ctx_lens = ctx_lens.to(self.device, torch.long)
        q_lens = q_lens.to(self.device, torch.long)
        h = self._embed_tokens(tokens)
        names = self.plane_names
        for i, blk in enumerate(self.blocks):
            h, _ = B.step_ragged_block(
                blk, self.cfg, h, tuple(cache[n][i] for n in names),
                ctx_lens, q_lens)
        new_cache = dict(cache)
        new_cache["pos"] = (ctx_lens + q_lens).to(torch.int32)
        return self._logits(h), new_cache

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
        return self._logits(h), new_cache

    @torch.no_grad()
    def step_paged_ragged(self, cache, tokens, ctx_lens, q_lens):
        """One fused mixed-batch step over the device page pool. tokens:
        (B, Qmax) — row ``b``'s ``q_lens[b]`` new tokens (0 marks padding
        rows); ctx_lens: (B,) tokens already pooled. Returns logits for
        every slot (B, Qmax, V) — callers read slot ``q_lens[b] - 1`` —
        and the cache with ``pos = ctx_lens + q_lens``."""
        cfg, table = self.cfg, cache["block_table"]
        ctx_lens = ctx_lens.to(self.device, torch.long)
        q_lens = q_lens.to(self.device, torch.long)
        h, pools = self._paged_layers(
            cache, self._embed_tokens(tokens),
            lambda blk, hh, planes: B.step_paged_ragged_block(
                blk, cfg, hh, planes, table, ctx_lens, q_lens))
        new_cache = {"pos": (ctx_lens + q_lens).to(torch.int32),
                     "block_table": table, **pools}
        return self._logits(h), new_cache


def params_from_jax(np_params: dict, cfg) -> dict:
    """A state dict for :class:`LM` from the JAX package's ``LM.init``
    pytree as numpy arrays (``jax.tree.map(np.asarray, params)``). The
    stacked ``params["blocks"]`` (leading L axis) — for a MoE config
    ``params["dense_blocks"]`` then ``params["moe_blocks"]`` — split into
    the ``ModuleList``; matrices keep the ``(d_in, d_out)`` layout (the
    experts their stacked ``(E, d_in, d_out)``). A tied config has no
    ``head``."""
    sd = {"embed": np_params["embed"]["table"],
          "final_ln": np_params["final_ln"]["scale"]}
    if not cfg.tie_embeddings:
        sd["head"] = np_params["head"]["table"]
    if cfg.family == "moe":
        n_dense = cfg.moe.first_k_dense
        layers = [("dense_blocks", i, "dense") for i in range(n_dense)]
        layers += [("moe_blocks", i, "moe")
                   for i in range(cfg.num_layers - n_dense)]
    else:
        layers = [("blocks", i, "dense") for i in range(cfg.num_layers)]
    for j, (stack, i, kind) in enumerate(layers):
        for name, arr in B.jax_block_arrays(np_params[stack], i, cfg,
                                            kind).items():
            sd[f"blocks.{j}.{name}"] = arr
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in sd.items()}
