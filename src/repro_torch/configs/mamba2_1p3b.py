"""Mamba2-1.3B [arXiv:2405.21060; hf:state-spaces/mamba2-1.3b].

Pure SSD (state-space duality) stack: 48 layers, d_model=2048, expand=2
(d_inner=4096), head_dim=64 (64 heads), d_state=128, conv width 4, no
attention, no FFN. Its decode cache is a fixed-size state row per
sequence (conv window + SSM state), not pages.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=0,
    ffn_activation="swiglu",
    norm_eps=1e-5,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    subquadratic=True,
    has_kv_cache=False,
)
