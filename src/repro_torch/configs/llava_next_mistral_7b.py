"""LLaVA-NeXT (mistral-7b) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Mistral-7B decoder backbone: 32 layers, d_model=4096, 32 heads GQA kv=8,
SwiGLU d_ff=14336, vocab 32000. Vision tower (CLIP-ViT-L/336 + anyres tiling)
is a stub: the caller passes precomputed patch embeddings (up to 2880
tokens = 5 tiles x 576 patches, d=1024; ``LM.prefill(...,
frontend_embeds=...)``), projected by the standard 2-layer MLP into d_model
and prepended to the text stream. Copied field for field from the JAX
package's config.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    ffn_activation="swiglu",
    rope_theta=1_000_000.0,
    norm_eps=1e-5,
    frontend=FrontendConfig(kind="vision", num_tokens=2880, d_frontend=1024,
                            projector_layers=2),
    subquadratic=False,
)
