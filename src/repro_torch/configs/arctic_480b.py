"""Snowflake Arctic (480B) [hf:Snowflake/snowflake-arctic-base].

Dense-MoE hybrid: every layer has a *parallel* dense FFN residual (d_ff=4864)
alongside a 128-expert top-2 MoE (d_expert=4864). GQA with 8 KV heads.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,                       # dense residual branch hidden dim
    vocab_size=32000,
    head_dim=128,
    ffn_activation="swiglu",
    rope_theta=10_000.0,
    norm_eps=1e-5,
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        d_expert=4864,
        dense_residual=True,
        d_dense_residual=4864,
        capacity_factor=1.25,
    ),
    subquadratic=False,
)
