"""DeepSeek-V2 (236B, 21B active) [arXiv:2405.04434;
hf:deepseek-ai/DeepSeek-V2], the same model without its experts, and the
model as published.

MLA attention at the published widths: the KV cache holds one 512-wide
latent and one 64-wide decoupled RoPE key per token, shared by all 128
heads (qk_nope 128 + qk_rope 64, v_head 128, q_lora_rank 1536). MoE: 2
shared + 160 routed experts, top-6, d_expert 1536; the first layer dense
(d_ff 12288).

``NOEXPERTS`` is the JAX package's ``deepseek-v2-236b`` after
``dataclasses.replace(cfg, family="attn_dense", moe=None)``, the
configuration its own tests use for the MLA cache: every layer runs the
published dense layer's FFN in place of the routed experts.

``CONFIG`` mirrors the JAX package's, which departs from the published
model: a plain top-6 renormalised to sum 1, capacity 1.25, RoPE with no
YaRN. ``PUBLISHED`` (``deepseek-v2-236b-published``, the port's own) is
the model as its ``config.json`` states it: ``group_limited_greedy``
routing (softmax over the 160 experts, the top 3 of 8 groups of 20, top-6
within them, the weights not renormalised and scaled by 16), drop-free
(no token dropped in serving, which the paper leaves open at inference),
and YaRN RoPE (factor 40 over 4096 positions, beta 32 / 1, mscale 0.707)
with its softmax scale. RoPE pairs the rope dims half-split, as the whole
port does: the checkpoint's interleaved pairing is a fixed permutation of
the rope columns of ``w_kr`` and ``w_uq``. ``PUBLISHED_SMOKE`` is its
smoke sibling, with 16 experts in 4 groups (top-2 groups, top-3) and a
q LoRA, so that every part of the routing and the attention is run.
"""
import dataclasses

from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      YarnConfig)

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,                # MLA: logical kv heads == q heads
    d_ff=12288,                      # the dense layers' FFN hidden
    vocab_size=102400,
    head_dim=128,                    # v head dim (qk uses nope+rope split)
    ffn_activation="swiglu",
    rope_theta=10_000.0,
    norm_eps=1e-6,
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        d_expert=1536,
        num_shared_experts=2,
        first_k_dense=1,
        capacity_factor=1.25,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    subquadratic=False,
)

NOEXPERTS = dataclasses.replace(CONFIG, name="deepseek-v2-236b-noexperts",
                                family="attn_dense", moe=None)

PUBLISHED = dataclasses.replace(
    CONFIG, name="deepseek-v2-236b-published",
    moe=dataclasses.replace(
        CONFIG.moe, topk_method="group_limited_greedy", n_group=8,
        topk_group=3, norm_topk_prob=False, routed_scaling_factor=16.0,
        drop_free=True),
    rope_scaling=YarnConfig(
        factor=40.0, original_max_position_embeddings=4096, beta_fast=32.0,
        beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707))

PUBLISHED_SMOKE = PUBLISHED.reduced(
    moe=dataclasses.replace(PUBLISHED.moe, num_experts=16, d_expert=64,
                            top_k=3, n_group=4, topk_group=2),
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=32,
                  qk_rope_head_dim=16, v_head_dim=32))
