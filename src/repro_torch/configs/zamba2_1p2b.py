"""Zamba2-1.2B [arXiv:2411.15242; hf:Zyphra/Zamba2-1.2B].

Hybrid: Mamba2 backbone (38 layers, d_model=2048, d_state=64) + shared
attention+MLP block(s) invoked periodically with per-invocation LoRA
projections (one set of shared transformer weights, cheap LoRA
specialization at each call site). Attention: 32 heads MHA over
2*d_model concat input in the real model; as in the JAX package, d_model
with 32 heads (head_dim 64), d_ff=8192 for the shared MLP. The
shared-attention KV is the only per-token cache.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ffn_activation="geglu",
    norm_eps=1e-5,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    hybrid=HybridConfig(shared_block_period=6, num_shared_blocks=2, lora_rank=8),
    subquadratic=True,
)
