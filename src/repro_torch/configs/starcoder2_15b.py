"""StarCoder2-15B [arXiv:2402.19173; hf:bigcode/starcoder2-15b].

Dense decoder, GQA (4 KV heads), RoPE, GELU (non-gated) FFN per the paper's
"FFN with pre-activation" — StarCoder2 uses plain GELU MLP with d_ff=4*d.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="attn_dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    ffn_activation="gelu",
    rope_theta=100_000.0,
    norm_eps=1e-5,
    subquadratic=False,
)
