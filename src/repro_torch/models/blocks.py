"""Blocks: parameters as ``nn.Module``s, math as functions.

The counterparts of the block functions of the JAX package's
``models/blocks.py``. The decoder block: pre-norm attention — GQA, or MLA when ``cfg.mla`` is
set — and an FFN, each added back through ``residual_scale``. The FFN is
the block's ``ffn_kind``: ``"dense"`` (gated for a GLU activation, two
matrices for plain GELU) or ``"moe"`` (routed experts,
:mod:`~repro_torch.models.moe`). The JAX block functions take
``ffn_kind`` as an argument because their parameters are plain pytrees;
here the block carries it. The cache-bearing functions dispatch on the
layer's cache planes as the JAX ones do: ``cfg.mla`` means the latent
``(c, kr)``, four planes mean int8 ``(k, v, k_scale, v_scale)``, two mean
dense ``(k, v)``.

An encoder-decoder's blocks: the encoder block (a dense decoder block's
parameters, run bidirectionally: :func:`apply_encoder_block`) and the
decoder block with cross-attention (a :class:`DecoderBlock` of
``ffn_kind="encdec"``: causal self-attention, cross-attention over the
encoder's K/V from :func:`cross_kv`, a dense FFN;
:func:`apply_encdec_decoder_block`, :func:`decode_encdec_decoder_block`).

The Mamba-2 block (:class:`SSMBlock`: a pre-norm SSD mixer, no FFN) and
Zamba2's shared attention block — a dense decoder block shared by several
call sites, each folding its own LoRA (:class:`LoRA`) into ``wq``/``wk``/
``wv`` (:func:`apply_shared_block`, :func:`decode_shared_block`).
:func:`step_ragged_ssm_block` is the SSM block's ragged step: the
single-token mixer scanned over the query slots, which keeps the per-slot
states a step may commit.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed.sharding import folded_weight, settle_residual
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_ffn, ffn_matrices, rmsnorm,
                                      truncated_normal_)
from repro_torch.models.moe import apply_moe, moe_matrices


def _gqa_matrices(c) -> dict:
    d = c.d_model
    return {"wq": (d, c.num_heads * c.head_dim),
            "wk": (d, c.num_kv_heads * c.head_dim),
            "wv": (d, c.num_kv_heads * c.head_dim),
            "wo": (c.num_heads * c.head_dim, d)}


def _matrices(c, ffn_kind: str) -> dict:
    """Block matrix name → (shape, JAX pytree path), for ``cfg``'s
    attention flavour and the block's FFN (``ffn_kind`` ``"encdec"``: the
    enc-dec decoder block, GQA ``self_attn`` and ``cross_attn`` and a
    dense FFN); matrices keep the JAX ``(d_in, ..., d_out)`` layout. A
    dotted name lives in a sub-module (``experts.w_gate``,
    ``cross_attn.wq``)."""
    d = c.d_model
    if ffn_kind == "encdec":
        out = {f"{a}.{n}": (shape, (a, n))
               for a in ("self_attn", "cross_attn")
               for n, shape in _gqa_matrices(c).items()}
        for n, shape in ffn_matrices(d, c.d_ff, c.ffn_activation).items():
            out[n] = (shape, ("ffn", n))
        return out
    if c.mla is None:
        attn = _gqa_matrices(c)
    else:
        m, H = c.mla, c.num_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        attn = ({"w_dq": (d, m.q_lora_rank), "w_uq": (m.q_lora_rank, H * qk)}
                if m.q_lora_rank else {"w_q": (d, H * qk)})
        attn.update({"w_dkv": (d, m.kv_lora_rank),
                     "w_kr": (d, m.qk_rope_head_dim),
                     "w_uk": (m.kv_lora_rank, H, m.qk_nope_head_dim),
                     "w_uv": (m.kv_lora_rank, H, m.v_head_dim),
                     "wo": (H * m.v_head_dim, d)})
    out = {n: (shape, ("attn", n)) for n, shape in attn.items()}
    if ffn_kind == "moe":
        ffn = moe_matrices(c)
    else:
        ffn = {n: (shape, (n,)) for n, shape in
               ffn_matrices(d, c.d_ff, c.ffn_activation).items()}
    for n, (shape, path) in ffn.items():
        out[n] = (shape, ("ffn",) + path)
    return out


def _norms(c, ffn_kind: str) -> dict:
    """Block RMSNorm scale name → (size, JAX pytree path)."""
    if ffn_kind == "encdec":
        return {n: (c.d_model, (n, "scale"))
                for n in ("ln_self", "ln_cross", "ln_ffn")}
    out = {"ln_attn": (c.d_model, ("ln_attn", "scale")),
           "ln_ffn": (c.d_model, ("ln_ffn", "scale"))}
    if c.mla is not None:
        if c.mla.q_lora_rank:
            out["q_norm"] = (c.mla.q_lora_rank, ("attn", "q_norm", "scale"))
        out["kv_norm"] = (c.mla.kv_lora_rank, ("attn", "kv_norm", "scale"))
    return out


def frozen_param(shape, dtype, device, fill=None):
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class DecoderBlock(nn.Module):
    """One decoder layer's parameters (GQA or MLA attention; a dense or
    MoE FFN, ``ffn_kind``), stored in the compute dtype. An encoder
    layer's parameters are a dense decoder layer's (the JAX
    ``init_encoder_block``); ``ffn_kind="encdec"`` is the enc-dec decoder
    layer: ``ln_self``, ``ln_cross`` and ``ln_ffn``, the ``self_attn`` and
    ``cross_attn`` GQA projections (sub-modules with ``wq``/``wk``/``wv``/
    ``wo``) and a dense FFN."""

    def __init__(self, cfg, dtype, device, ffn_kind: str):
        super().__init__()
        self.ffn_kind = ffn_kind
        norms, matrices = _norms(cfg, ffn_kind), _matrices(cfg, ffn_kind)
        self._norm_names, self._matrix_names = tuple(norms), tuple(matrices)
        for name, (size, _) in norms.items():
            setattr(self, name, frozen_param((size,), dtype, device, 1.0))
        for name, (shape, _) in matrices.items():
            owner = self
            *path, leaf = name.split(".")
            for part in path:
                if not hasattr(owner, part):
                    setattr(owner, part, nn.Module())
                owner = getattr(owner, part)
            setattr(owner, leaf, frozen_param(shape, dtype, device))

    def init_weights(self, generator) -> None:
        """The JAX package's init distributions: truncated normal with
        ``std = 1/sqrt(fan_in)`` (fan_in the first axis; for the stacked
        ``experts.*`` the first axis of each expert's matrix, drawn one
        expert at a time), norm scales at 1."""
        for name in self._norm_names:
            getattr(self, name).data.fill_(1.0)
        for name in self._matrix_names:
            t = self.get_parameter(name)
            if name.startswith("experts."):
                for e in range(t.shape[0]):
                    truncated_normal_(t[e], 1.0, generator,
                                      fan_in=t.shape[1])
            else:
                truncated_normal_(t, 1.0, generator)


def _branch_in(scale, cfg, h):
    """A branch's input: ``h`` normed, its gradient settled on a mesh
    (:func:`~repro_torch.distributed.sharding.settle_residual`)."""
    return settle_residual(rmsnorm(scale, h, cfg.norm_eps), h)


def _ffn_aux(p, cfg, h):
    """The block's FFN half: ``(h, aux)``, ``aux`` the MoE load-balancing
    loss (fp32 scalar), None for a dense FFN."""
    x = _branch_in(p.ln_ffn, cfg, h)
    if p.ffn_kind == "moe":
        f, aux = apply_moe(p, cfg, x, getattr(p, "ep_axes", ()))
    else:
        f, aux = apply_ffn(p, x, cfg.ffn_activation), None
    return h + cfg.residual_scale * settle_residual(f, h), aux


def _ffn(p, cfg, h):
    return _ffn_aux(p, cfg, h)[0]


def _attn_half(p, cfg, h, positions, chunk_size):
    x = _branch_in(p.ln_attn, cfg, h)
    train = attn_mod.mla_train if cfg.mla is not None else attn_mod.attn_train
    a, kv = train(p, cfg, x, positions, chunk_size=chunk_size)
    return h + cfg.residual_scale * settle_residual(a, h), kv


def apply_decoder_block(p, cfg, h, positions, *, chunk_size: int = 512):
    """Full-sequence block (prefill). Returns ``(h, cache pair)``:
    ``(k, v)`` for GQA, ``(c_kv, k_rope)`` for MLA."""
    h, kv = _attn_half(p, cfg, h, positions, chunk_size)
    return _ffn(p, cfg, h), kv


def train_decoder_block(p, cfg, h, positions, *, chunk_size: int = 512):
    """Full-sequence block on the loss path: ``(h, aux)``, the MoE
    load-balancing loss in place of the cache pair (0 for a dense FFN),
    as the JAX block returns it beside ``h``."""
    h, _ = _attn_half(p, cfg, h, positions, chunk_size)
    h, aux = _ffn_aux(p, cfg, h)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux


def decode_decoder_block(p, cfg, h, cache, positions):
    """Single-token block over one layer's dense cache planes, written in
    place: ``(c, kr)`` MLA, ``(k, v, k_scale, v_scale)`` int8, ``(k, v)``
    dense."""
    x = _branch_in(p.ln_attn, cfg, h)
    if cfg.mla is not None:
        step = attn_mod.mla_decode
    elif len(cache) == 4:
        step = attn_mod.attn_decode_q8
    else:
        step = attn_mod.attn_decode
    a, *cache = step(p, cfg, x, *cache, positions)
    return (_ffn(p, cfg, h + cfg.residual_scale * settle_residual(a, h)),
            tuple(cache))


def step_ragged_block(p, cfg, h, cache, ctx_lens, q_lens):
    """Ragged multi-token block over one layer's dense cache planes,
    written in place (the dense-mirror path's fused tick), dispatched as
    :func:`decode_decoder_block`."""
    x = _branch_in(p.ln_attn, cfg, h)
    if cfg.mla is not None:
        step = attn_mod.mla_decode_ragged
    elif len(cache) == 4:
        step = attn_mod.attn_decode_ragged_q8
    else:
        step = attn_mod.attn_decode_ragged
    a, *cache = step(p, cfg, x, *cache, ctx_lens, q_lens)
    return (_ffn(p, cfg, h + cfg.residual_scale * settle_residual(a, h)),
            tuple(cache))


def decode_paged_block(p, cfg, h, planes, block_table, positions):
    """Single-token block over one layer's pool planes (descriptor
    order), dispatched as :func:`decode_decoder_block`."""
    x = _branch_in(p.ln_attn, cfg, h)
    if cfg.mla is not None:
        step = attn_mod.mla_decode_paged
    elif len(planes) == 4:
        step = attn_mod.attn_decode_paged_q8
    else:
        step = attn_mod.attn_decode_paged
    a, *planes = step(p, cfg, x, *planes, block_table, positions)
    return (_ffn(p, cfg, h + cfg.residual_scale * settle_residual(a, h)),
            tuple(planes))


def step_paged_ragged_block(p, cfg, h, planes, block_table, ctx_lens,
                            q_lens):
    """Ragged multi-token block over one layer's pool planes (the fused
    mixed-batch tick), dispatched as :func:`decode_decoder_block`."""
    x = _branch_in(p.ln_attn, cfg, h)
    if cfg.mla is not None:
        step = attn_mod.mla_step_paged_ragged
    elif len(planes) == 4:
        step = attn_mod.attn_step_paged_ragged_q8
    else:
        step = attn_mod.attn_step_paged_ragged
    a, *planes = step(p, cfg, x, *planes, block_table, ctx_lens, q_lens)
    return (_ffn(p, cfg, h + cfg.residual_scale * settle_residual(a, h)),
            tuple(planes))


def apply_encoder_block(p, cfg, h, positions, *, chunk_size: int = 512):
    """Bidirectional encoder block over a full sequence: non-causal
    self-attention (the flash kernel past ``chunk_size``), then the FFN;
    no ``residual_scale``, as in JAX."""
    x = _branch_in(p.ln_attn, cfg, h)
    a, _ = attn_mod.attn_train(p, cfg, x, positions, causal=False,
                               chunk_size=chunk_size)
    h = h + settle_residual(a, h)
    x = _branch_in(p.ln_ffn, cfg, h)
    return h + settle_residual(apply_ffn(p, x, cfg.ffn_activation), h)


def cross_kv(p, cfg, enc_out):
    """The cross-attention K/V (B, T, K, D) of encoder output ``enc_out``
    (B, T, d), computed once a prompt."""
    B, T, _ = enc_out.shape
    K, D = cfg.num_kv_heads, cfg.head_dim
    heads = attn_mod._whole_head_groups
    return (heads(enc_out @ p.cross_attn.wk, K).reshape(B, T, K, D),
            heads(enc_out @ p.cross_attn.wv, K).reshape(B, T, K, D))


def apply_encdec_decoder_block(p, cfg, h, positions, enc_k, enc_v, *,
                               chunk_size: int = 512):
    """Full-sequence enc-dec decoder block: causal self-attention,
    cross-attention over ``enc_k``/``enc_v``, FFN. Returns ``(h, (k, v))``,
    the self-attention cache pair."""
    x = _branch_in(p.ln_self, cfg, h)
    a, kv = attn_mod.attn_train(p.self_attn, cfg, x, positions, causal=True,
                                chunk_size=chunk_size)
    h = h + settle_residual(a, h)
    x = _branch_in(p.ln_cross, cfg, h)
    h = h + settle_residual(attn_mod.attn_cross(
        p.cross_attn, cfg, x, enc_k, enc_v, chunk_size=chunk_size), h)
    x = _branch_in(p.ln_ffn, cfg, h)
    return h + settle_residual(apply_ffn(p, x, cfg.ffn_activation), h), kv


def decode_encdec_decoder_block(p, cfg, h, cache, positions):
    """Single-token enc-dec decoder block over ``(k, v, ek, ev)``: the
    self-attention cache written in place, cross-attention at the default
    ``chunk_size`` (as the JAX block calls it). Returns ``(h, (k, v))``."""
    ck, cv, ek, ev = cache
    x = _branch_in(p.ln_self, cfg, h)
    a, ck, cv = attn_mod.attn_decode(p.self_attn, cfg, x, ck, cv, positions)
    h = h + settle_residual(a, h)
    x = _branch_in(p.ln_cross, cfg, h)
    h = h + settle_residual(attn_mod.attn_cross(p.cross_attn, cfg, x, ek, ev),
                            h)
    x = _branch_in(p.ln_ffn, cfg, h)
    return (h + settle_residual(apply_ffn(p, x, cfg.ffn_activation), h),
            (ck, cv))


def jax_block_arrays(np_blocks: dict, i: int, cfg, ffn_kind: str) -> dict:
    """Layer ``i`` of one of the JAX package's stacked block pytrees
    (``params["blocks"]``, ``["dense_blocks"]``, ``["moe_blocks"]`` or
    ``["enc_blocks"]``, leading L axis; ``["dec_blocks"]`` with
    ``ffn_kind="encdec"``) as ``{port name: numpy array}``."""
    out = {}
    for name, (_, path) in {**_matrices(cfg, ffn_kind),
                            **_norms(cfg, ffn_kind)}.items():
        node = np_blocks
        for key in path:
            node = node[key]
        out[name] = node[i]
    return out


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------
class SSMBlock(nn.Module):
    """One Mamba-2 layer's parameters: the pre-norm scale ``ln`` and the
    SSD mixer's (:func:`~repro_torch.models.ssm.mixer_shapes`), all in
    the compute dtype."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.ln = frozen_param((cfg.d_model,), dtype, device, 1.0)
        for name, shape in ssm_mod.mixer_shapes(cfg).items():
            setattr(self, name, frozen_param(shape, dtype, device))

    def init_weights(self, generator) -> None:
        self.ln.data.fill_(1.0)
        ssm_mod.init_mixer_(self, self.cfg, generator)


def apply_ssm_block(p, cfg, h, initial_state=None):
    """Full-sequence block. Returns ``(h, (conv_state, ssm_state))``."""
    x = _branch_in(p.ln, cfg, h)
    y, state = ssm_mod.apply_ssm(p, cfg, x, initial_state)
    return h + settle_residual(y, h), state


def decode_ssm_block(p, cfg, h, conv_state, ssm_state):
    """Single-token block. Returns ``(h, conv_state, ssm_state)``, the
    states new tensors."""
    x = _branch_in(p.ln, cfg, h)
    y, (conv_state, ssm_state) = ssm_mod.ssm_decode(p, cfg, x, conv_state,
                                                    ssm_state)
    return h + settle_residual(y, h), conv_state, ssm_state


def _keep_index(keep_from, n_keep: int, qmax: int, device):
    """The slot captures of a ragged SSM step that keeps ``n_keep`` slot
    states a row, row ``b``'s from slot ``keep_from[b]`` (host ints): one
    ``(2, n)`` device tensor of ``(keep index, row)`` pairs ordered by slot,
    and each slot's ``(start, end)`` span in it."""
    pairs, spans = [], []
    for j in range(qmax):
        start = len(pairs)
        pairs += [(j - f, b) for b, f in enumerate(keep_from)
                  if 0 <= j - f < n_keep]
        spans.append((start, len(pairs)))
    idx = torch.tensor(pairs, dtype=torch.long).reshape(-1, 2).T
    return idx.to(device), spans


def step_ragged_ssm_block(p, cfg, h, conv_state, ssm_state, q_lens,
                          keep=None):
    """Ragged multi-token SSM block: the single-step mixer scanned over the
    Qmax query slots, state updates masked past ``q_lens`` so padding slots
    leave the state as it is. h: (B, Qmax, d). Returns ``(h, conv_steps,
    ssm_steps)``, the per-slot states the caller commits from (an earlier
    slot is the speculative rollback).

    ``keep=None`` keeps every slot, ``(Qmax, B, ...)`` as in the
    reference. ``keep = (keep_from, n_keep)`` keeps only the slots a row
    can commit: ``(n_keep, B, ...)``, entry ``k`` of row ``b`` the state
    after slot ``keep_from[b] + k`` (entries no slot reaches stay 0). The
    kept states are the full stack's entries, bit for bit."""
    B, Qm, _ = h.shape
    live_all = (torch.arange(Qm, device=h.device)[:, None]
                < q_lens.to(h.device)[None, :])                 # (Qm, B)
    if keep is None:
        conv_keep, ssm_keep = [], []
    else:
        keep_from, n_keep = keep
        idx, spans = _keep_index(keep_from, n_keep, Qm, h.device)
        conv_keep = conv_state.new_zeros((n_keep,) + conv_state.shape)
        ssm_keep = ssm_state.new_zeros((n_keep,) + ssm_state.shape)
    conv, ssm = conv_state, ssm_state
    ys = []
    for j in range(Qm):
        x = rmsnorm(p.ln, h[:, j:j + 1], cfg.norm_eps)
        y, (nc, ns) = ssm_mod.ssm_decode(p, cfg, x, conv, ssm)
        live = live_all[j]
        conv = torch.where(live[:, None, None], nc, conv)
        ssm = torch.where(live[:, None, None, None], ns, ssm)
        ys.append(y[:, 0])
        if keep is None:
            conv_keep.append(conv)
            ssm_keep.append(ssm)
        elif spans[j][0] < spans[j][1]:
            k, b = idx[:, spans[j][0]:spans[j][1]]
            conv_keep[k, b] = conv[b]
            ssm_keep[k, b] = ssm[b]
    if keep is None:
        conv_keep, ssm_keep = torch.stack(conv_keep), torch.stack(ssm_keep)
    return h + torch.stack(ys, dim=1), conv_keep, ssm_keep


def ssm_block_arrays(np_blocks: dict, index) -> dict:
    """One layer of a JAX package's stacked SSM block pytree
    (``params["blocks"]``, ``["mamba_seg"]`` or ``["mamba_tail"]``) as
    ``{port name: numpy array}``; ``index`` picks the layer (a tuple for
    ``mamba_seg``'s ``(segment, layer)`` axes)."""
    out = {"ln": np_blocks["ln"]["scale"][index]}
    for name, arr in np_blocks["mixer"].items():
        out[name] = arr[index]
    return out


# ---------------------------------------------------------------------------
# Zamba2 shared block with per-invocation LoRA
# ---------------------------------------------------------------------------
class LoRA(nn.Module):
    """One call site's LoRA on the shared block's fused q/k/v projection:
    ``a`` (d, r), ``b`` (r, (H + 2K)·D)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        r = cfg.hybrid.lora_rank
        qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
        self.a = frozen_param((cfg.d_model, r), dtype, device)
        self.b = frozen_param((r, qkv_out), dtype, device, 0.0)

    def init_weights(self, generator) -> None:
        truncated_normal_(self.a, 1.0, generator)
        self.b.data.zero_()


class _LoraPatched:
    """A shared block's parameters with one call site's LoRA delta folded
    into ``wq``/``wk``/``wv``; every other name reads the shared block,
    each weight as a product with the call site's hidden state ``h``
    takes it (:func:`~repro_torch.distributed.sharding.folded_weight`:
    gathered on ``model`` where a train cell folds the batch there)."""

    def __init__(self, shared, h, wq, wk, wv):
        self._shared, self._h = shared, h
        self.wq, self.wk, self.wv = wq, wk, wv

    def __getattr__(self, name):
        w = folded_weight(getattr(self._shared, name), self._h)
        setattr(self, name, w)              # one gather a call site
        return w


def _lora_patched_attn(shared, lora, cfg, h):
    H, K, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    delta = lora.a @ lora.b                                # (d, qkv_out)
    dq, dk, dv = torch.split(delta, [H * D, K * D, K * D], dim=-1)
    return _LoraPatched(shared, h, folded_weight(shared.wq, h) + dq,
                        folded_weight(shared.wk, h) + dk,
                        folded_weight(shared.wv, h) + dv)


def apply_shared_block(shared, lora, cfg, h, positions, chunk_size=512):
    """Full-sequence shared block at one call site. Returns ``(h, (k, v))``."""
    return apply_decoder_block(_lora_patched_attn(shared, lora, cfg, h), cfg,
                               h, positions, chunk_size=chunk_size)


def decode_shared_block(shared, lora, cfg, h, cache, positions):
    """Single-token shared block over the call site's ``(k, v)`` cache,
    written in place."""
    return decode_decoder_block(_lora_patched_attn(shared, lora, cfg, h),
                                cfg, h, cache, positions)
