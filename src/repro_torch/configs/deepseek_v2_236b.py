"""DeepSeek-V2 (236B, 21B active) [arXiv:2405.04434;
hf:deepseek-ai/DeepSeek-V2], and the same model without its experts.

MLA attention at the published widths: the KV cache holds one 512-wide
latent and one 64-wide decoupled RoPE key per token, shared by all 128
heads (qk_nope 128 + qk_rope 64, v_head 128, q_lora_rank 1536). MoE: 2
shared + 160 routed experts, top-6, d_expert 1536; the first layer dense
(d_ff 12288).

``NOEXPERTS`` is the JAX package's ``deepseek-v2-236b`` after
``dataclasses.replace(cfg, family="attn_dense", moe=None)``, the
configuration its own tests use for the MLA cache: every layer runs the
published dense layer's FFN in place of the routed experts.
"""
import dataclasses

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

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
