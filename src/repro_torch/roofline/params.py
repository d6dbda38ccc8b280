"""Analytic parameter counts per architecture: the port's copy of the JAX
package's ``roofline/params.py`` (the roofline's 6·N·D cross-check there;
``ModelConfig.param_count()`` and the training CLI's banner here). The
counts use the unpadded vocab."""
from __future__ import annotations


def _dense_ffn_params(d_model: int, d_ff: int, activation: str) -> int:
    if d_ff == 0:
        return 0
    mats = 3 if activation in ("swiglu", "geglu") else 2
    return mats * d_model * d_ff


def _attn_params(cfg) -> int:
    if cfg.mla is not None:
        m = cfg.mla
        qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
        p = 0
        if m.q_lora_rank:
            p += cfg.d_model * m.q_lora_rank + m.q_lora_rank * cfg.num_heads * qk_head
            p += m.q_lora_rank  # q lora norm
        else:
            p += cfg.d_model * cfg.num_heads * qk_head
        p += cfg.d_model * (m.kv_lora_rank + m.qk_rope_head_dim)   # W_dkv, W_kr
        p += m.kv_lora_rank                                        # kv lora norm
        p += m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
        p += cfg.num_heads * m.v_head_dim * cfg.d_model            # W_o
        return p
    q = cfg.d_model * cfg.num_heads * cfg.head_dim
    kv = 2 * cfg.d_model * cfg.num_kv_heads * cfg.head_dim
    o = cfg.num_heads * cfg.head_dim * cfg.d_model
    return q + kv + o


def _ssm_params(cfg) -> int:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.ngroups * s.d_state
    p = cfg.d_model * (2 * d_inner + 2 * s.ngroups * s.d_state + nheads)  # in_proj
    p += conv_dim * s.d_conv + conv_dim                                   # conv + bias
    p += 3 * nheads                                                       # A, D, dt_bias
    p += d_inner                                                          # gated norm
    p += d_inner * cfg.d_model                                            # out_proj
    return p


def _moe_ffn_params(cfg, active: bool) -> int:
    m = cfg.moe
    n_routed = m.top_k if active else m.num_experts
    p = cfg.d_model * m.num_experts                       # router
    p += n_routed * 3 * cfg.d_model * m.d_expert          # routed experts (glu)
    p += m.num_shared_experts * 3 * cfg.d_model * m.d_expert
    if m.dense_residual:
        p += 3 * cfg.d_model * m.d_dense_residual
    return p


def _layer_params(cfg, active: bool) -> int:
    fam = cfg.family
    norms = 2 * cfg.d_model
    if fam in ("attn_dense", "vlm"):
        return _attn_params(cfg) + _dense_ffn_params(
            cfg.d_model, cfg.d_ff, cfg.ffn_activation) + norms
    if fam == "moe":
        return _attn_params(cfg) + _moe_ffn_params(cfg, active) + norms
    if fam == "ssm":
        return _ssm_params(cfg) + cfg.d_model
    if fam == "encdec":
        # decoder layer: self + cross + ffn
        return (2 * _attn_params(cfg)
                + _dense_ffn_params(cfg.d_model, cfg.d_ff, cfg.ffn_activation)
                + 3 * cfg.d_model)
    if fam == "hybrid":
        return _ssm_params(cfg) + cfg.d_model
    raise ValueError(fam)


def count_params(cfg, active: bool = False) -> int:
    p = cfg.vocab_size * cfg.d_model                       # embedding
    if not cfg.tie_embeddings:
        p += cfg.vocab_size * cfg.d_model                  # lm head
    p += cfg.d_model                                       # final norm

    if cfg.family == "moe" and cfg.moe.first_k_dense:
        k = cfg.moe.first_k_dense
        dense_layer = _attn_params(cfg) + _dense_ffn_params(
            cfg.d_model, cfg.d_ff, cfg.ffn_activation) + 2 * cfg.d_model
        p += k * dense_layer + (cfg.num_layers - k) * _layer_params(cfg, active)
    else:
        p += cfg.num_layers * _layer_params(cfg, active)

    if cfg.family == "encdec":
        enc_layer = (_attn_params(cfg) + _dense_ffn_params(
            cfg.d_model, cfg.d_ff, cfg.ffn_activation) + 2 * cfg.d_model)
        p += cfg.num_encoder_layers * enc_layer

    if cfg.family == "hybrid":
        h = cfg.hybrid
        shared_block = (_attn_params(cfg) + _dense_ffn_params(
            cfg.d_model, cfg.d_ff, cfg.ffn_activation) + 2 * cfg.d_model)
        p += h.num_shared_blocks * shared_block
        n_invocations = cfg.num_layers // h.shared_block_period
        qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
        p += n_invocations * h.lora_rank * (cfg.d_model + qkv_out)

    if cfg.frontend.kind == "vision":
        d_f = cfg.frontend.d_frontend
        p += d_f * cfg.d_model + cfg.d_model * cfg.d_model * (
            cfg.frontend.projector_layers - 1)
    return p


def count_active_params(cfg) -> int:
    return count_params(cfg, active=True)
