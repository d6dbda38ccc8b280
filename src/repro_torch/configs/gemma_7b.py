"""Gemma-7B [arXiv:2403.08295; hf:google/gemma-7b].

Dense decoder: 16 heads with head_dim=256 (q_dim 4096 > d_model 3072), MHA
(kv=16; the 2B sibling uses MQA), GeGLU FFN (d_ff=24576 is the *combined*
gate+up published figure; per-branch hidden is 24576/... Gemma reports
hidden_dim=24576 as the per-branch intermediate), RMSNorm, RoPE,
embedding scaled by sqrt(d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="attn_dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    ffn_activation="geglu",
    rope_theta=10_000.0,
    norm_eps=1e-6,
    tie_embeddings=True,
    embedding_scale=3072 ** 0.5,
    subquadratic=False,
)
