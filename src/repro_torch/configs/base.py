"""Model config dataclasses for the PyTorch port.

The port's own copy of the decoder part of the JAX package's
``ModelConfig``: the fields a dense GQA or MLA (multi-head latent
attention) decoder reads — with a gated or plain FFN, or a routed
mixture of experts (``MoEConfig``) — a Mamba-2 state-space stack
(``SSMConfig``) and the Zamba2 hybrid of it with shared attention blocks
(``HybridConfig``), an encoder-decoder's encoder depth and a stub
modality frontend (``FrontendConfig``: precomputed audio frames or image
patches), the padded-vocab rule, the training schedule hint
(``lr_schedule``), ``param_count()`` and ``active_param_count()`` (the
training CLI's banner and the roofline), ``reduced()`` for the
smoke-sized sibling, and the dry run's input shapes (``InputShape``: the
four cells ``TRAIN_4K`` … ``LONG_500K``, ``applicable_shapes`` and
``skipped_shapes``).

Beyond the JAX package's fields, and at defaults that keep its behaviour:
``MoEConfig``'s routing method (DeepSeek-V2's group-limited greedy top-k,
its weights unnormalised and scaled), the slice of experts a layer holds
(one chip's share of an expert-parallel layer) and its drop-free mode;
``ModelConfig.rope_scaling`` (``YarnConfig``, YaRN's RoPE frequencies and
MLA's softmax scale).
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
    # routing: "greedy" (top-k of all experts) or DeepSeek-V2's
    # "group_limited_greedy" (top-k within the top ``topk_group`` of
    # ``n_group`` expert groups, a group scored by its best expert); the
    # top-k weights renormalised to sum 1 (``norm_topk_prob``), then
    # scaled by ``routed_scaling_factor``
    topk_method: str = "greedy"
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    # the experts this layer holds, ``first_held ..
    # first_held + num_held - 1`` of the router's ``num_experts`` (0: all):
    # one chip's share of an expert-parallel layer
    first_held: int = 0
    num_held: int = 0
    # no capacity: every (token, held expert) pair is computed
    # (``capacity_factor`` unread), and a serving step routes only its
    # real tokens, never a padding slot
    drop_free: bool = False

    @property
    def held(self) -> int:
        """How many experts the layer holds."""
        return self.num_held or self.num_experts


@dataclass(frozen=True)
class YarnConfig:
    """YaRN's RoPE scaling (arXiv:2309.00071) as DeepSeek-V2 configures
    it: ``factor`` over ``original_max_position_embeddings``, the ramp
    between the dims that turn ``beta_fast`` and ``beta_slow`` times over
    the original context, and the attention's mscale terms."""
    factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707


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
    rope_scaling: Optional[YarnConfig] = None
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
    # training schedule hint (minicpm WSD), read by launch/train.py
    lr_schedule: str = "cosine"    # "cosine" | "wsd"
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

    def param_count(self) -> int:
        """Analytic parameter count (unpadded vocab), as the reference
        counts it."""
        from repro_torch.roofline.params import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        """Parameters one token runs through (the top-k routed experts of
        a MoE config, not all of them), as the reference counts them."""
        from repro_torch.roofline.params import count_active_params
        return count_active_params(self)

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


# ---------------------------------------------------------------------------
# The dry run's input shapes (the reference's pool)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = InputShape("train_4k", "train", 4_096, 256)
PREFILL_32K = InputShape("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = InputShape("decode_32k", "decode", 32_768, 128)
LONG_500K = InputShape("long_500k", "decode", 524_288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def applicable_shapes(cfg: ModelConfig) -> list[InputShape]:
    """The shape cells that are live for this arch: train, prefill and
    decode for every arch (all have a decoder), the 512k-token decode
    only for a sub-quadratic backbone."""
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        shapes.append(LONG_500K)
    return shapes


def skipped_shapes(cfg: ModelConfig) -> list[tuple[str, str]]:
    """(shape, reason) pairs of the cells :func:`applicable_shapes` leaves
    out."""
    out = []
    if not cfg.subquadratic:
        out.append(("long_500k",
                    "pure full-attention arch: 512k-token decode reserved for "
                    "sub-quadratic backbones per shape-pool rule"))
    return out
