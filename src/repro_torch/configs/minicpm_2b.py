"""MiniCPM-2B [arXiv:2404.06395; hf:openbmb/MiniCPM-2B-sft-bf16].

Llama-like dense decoder (trained with the WSD schedule, which the port does
not carry: it has no training yet).
36 query heads = 36 KV heads (MHA), head_dim 64. MiniCPM uses mup-style
depth/width scaling: residual branches scaled by 1.4/sqrt(num_layers),
embeddings scaled by 12, logits divided by (d_model/256); embeddings tied.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="attn_dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    head_dim=64,
    ffn_activation="swiglu",
    rope_theta=10_000.0,
    norm_eps=1e-5,
    tie_embeddings=True,
    residual_scale=1.4 / (40 ** 0.5),     # depth_scale per MiniCPM §4
    embedding_scale=12.0,
    logit_scale=256.0 / 2304.0,           # 1/(d_model/dim_model_base)
    subquadratic=False,
)
