"""Model config dataclasses for the PyTorch port.

The port's own copy of the decoder part of the JAX package's
``ModelConfig``: the fields a dense GQA or MLA (multi-head latent
attention) decoder reads — with a gated or plain FFN, or a routed
mixture of experts (``MoEConfig``) — a Mamba-2 state-space stack
(``SSMConfig``) and the Zamba2 hybrid of it with shared attention blocks
(``HybridConfig``), an encoder-decoder's encoder depth and a stub
modality frontend (``FrontendConfig``: precomputed audio frames or image
patches), the padded-vocab rule, and ``reduced()`` for the smoke-sized
sibling.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 2
    d_expert: int = 0              # per-expert FFN hidden dim
    num_shared_experts: int = 0    # DeepSeek-style always-on experts
    dense_residual: bool = False   # Arctic-style dense FFN in parallel
    d_dense_residual: int = 0      # hidden dim of the parallel dense FFN
    first_k_dense: int = 0         # leading layers with a dense FFN, not MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention widths."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0           # 0 = full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD mixer widths."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    ngroups: int = 1
    chunk_size: int = 256


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2: a shared attention block every ``shared_block_period``
    SSM layers, ``num_shared_blocks`` of them used round-robin, each
    invocation with its own rank-``lora_rank`` LoRA on q/k/v."""
    shared_block_period: int = 6
    num_shared_blocks: int = 2
    lora_rank: int = 8


@dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend: the caller hands in precomputed embeddings
    (``frontend_embeds``) — audio frames of width ``d_model`` for an
    encoder-decoder, or ``num_tokens`` image patches of width
    ``d_frontend`` that a ``projector_layers``-deep MLP projects into
    ``d_model`` and prepends to the text (a VLM)."""
    kind: str = "none"              # "audio" | "vision" | "none"
    num_tokens: int = 0             # frontend tokens prepended to the text
    d_frontend: int = 0             # embedding width the stub delivers
    projector_layers: int = 2       # MLP projector depth (vision)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 → d_model // num_heads
    max_seq_len: int = 524_288
    # FFN activation: "swiglu" | "geglu" | "gelu"
    ffn_activation: str = "swiglu"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    residual_scale: float = 1.0
    embedding_scale: float = 1.0
    logit_scale: float = 1.0
    logit_soft_cap: float = 0.0
    subquadratic: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    num_encoder_layers: int = 0    # encoder-decoder: the encoder's depth
    has_kv_cache: bool = True      # False for pure SSM
    # embedding tables are allocated padded to this multiple; the padded
    # logit columns are masked
    vocab_pad_multiple: int = 256

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized sibling of this config (same family/topology)."""
        small = dict(
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads else 0,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            max_seq_len=1024,
        )
        if self.num_encoder_layers:
            small["num_encoder_layers"] = 2
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 8),
                d_expert=64,
                d_dense_residual=64 if self.moe.dense_residual else 0,
                top_k=min(self.moe.top_k, 2),
            )
        if self.mla is not None:
            small["mla"] = MLAConfig(
                kv_lora_rank=32, q_lora_rank=0,
                qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
            small["head_dim"] = 32
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk_size=64)
        if self.hybrid is not None:
            small["hybrid"] = dataclasses.replace(
                self.hybrid, shared_block_period=2, num_shared_blocks=1,
                lora_rank=4)
        if self.frontend.kind != "none":
            small["frontend"] = dataclasses.replace(
                self.frontend, num_tokens=16, d_frontend=64)
        small.update(overrides)
        return dataclasses.replace(self, name=self.name + "-smoke", **small)
