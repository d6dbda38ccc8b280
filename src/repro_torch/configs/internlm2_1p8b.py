"""InternLM2-1.8B [arXiv:2403.17297; hf:internlm/internlm2-1_8b].

Llama-like dense decoder: GQA with 8 KV heads, SwiGLU FFN, RMSNorm, RoPE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="attn_dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    head_dim=128,
    ffn_activation="swiglu",
    rope_theta=1_000_000.0,
    norm_eps=1e-5,
    subquadratic=False,
)
