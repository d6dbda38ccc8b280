"""SeamlessM4T-Large v2 [arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large].

Encoder-decoder transformer backbone (text decoder of the multimodal system):
24 encoder + 24 decoder layers, d_model=1024, 16 heads, d_ff=8192,
vocab 256206. The speech frontend (w2v-BERT conformer stack) is a stub:
the caller passes precomputed 1024-dim frame embeddings
(``LM.prefill(..., frontend_embeds=...)``). Copied field for field from the
JAX package's config.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,                   # decoder layers
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    ffn_activation="gelu",
    rope_theta=10_000.0,             # HF: learned positions; RoPE, as JAX
    norm_eps=1e-5,
    frontend=FrontendConfig(kind="audio", num_tokens=4096, d_frontend=1024),
    subquadratic=False,
)
