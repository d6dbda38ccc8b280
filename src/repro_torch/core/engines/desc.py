"""Per-family cache descriptors: ONE frozen spec of a model family's cache
layout that drives the pooled mirror-free serving path end to end.

The port's copy of the JAX package's descriptors. A
:class:`CacheDescriptor` makes the layout data, not code:

* **paged planes** — per-token arrays that live in the device page pool as
  ``(L, P, page_tokens, *shape)``; each plane carries its own dtype (int8
  KV pages ride next to bf16 scale planes) and its name matches the
  model's prefill cache key (``k``/``v``/``k_scale``/``v_scale``/``c``/
  ``kr``).
* **seq planes** — per-sequence state rows (SSM ``conv``/``ssm`` states)
  that ride alongside the page tables: committed, spilled, preempted and
  restored with the row rather than with pages.

Plane dtypes are kept as NAMES (``"float32"``, ``"bfloat16"``, ...):
numpy has no bfloat16, so :data:`_DTYPES` maps each name to its torch
dtype and itemsize, and the byte math (hence every byte counter) is the
same in both packages. The hybrid (Zamba2) and encoder-decoder families
have no descriptor: they keep the dense-mirror path, as in JAX.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

#: plane dtype name → (torch dtype, itemsize in bytes)
_DTYPES = {
    "float32": (torch.float32, 4),
    "bfloat16": (torch.bfloat16, 2),
    "float16": (torch.float16, 2),
    "int8": (torch.int8, 1),
}

#: the plane-name universe across every family — the uniform key set behind
#: the per-plane ``pool_d2h_bytes_<plane>`` / ``pool_h2d_bytes_<plane>``
#: counters (zeroed for planes a pool does not hold)
PLANE_STAT_NAMES: tuple = ("k", "v", "k_scale", "v_scale", "c", "kr",
                           "conv", "ssm")


def dtype_name(dtype) -> str:
    """The plane dtype name of a torch dtype (``torch.bfloat16`` →
    ``"bfloat16"``); names pass through after validation."""
    name = dtype if isinstance(dtype, str) else str(dtype).split(".")[-1]
    if name not in _DTYPES:
        raise ValueError(f"unsupported plane dtype {dtype!r}; known: "
                         f"{sorted(_DTYPES)}")
    return name


@dataclass(frozen=True)
class PlaneSpec:
    """One named cache plane.

    For paged planes ``shape`` is the per-token trailing shape (a page is
    ``(page_tokens, *shape)`` per layer); for seq planes it is the whole
    per-layer per-sequence state shape.
    """
    name: str
    shape: tuple
    dtype: str
    kind: str = "kv"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype][0]

    @property
    def itemsize(self) -> int:
        return _DTYPES[self.dtype][1]

    @property
    def entry_bytes(self) -> int:
        """Bytes of one entry: per token (paged) or per seq-layer (state)."""
        return int(math.prod(self.shape)) * self.itemsize


@dataclass(frozen=True)
class CacheDescriptor:
    """Frozen layout spec for one model family's decode cache."""
    family: str                 # cache-layout family: dense | mla | int8 | ssm
    num_layers: int
    page_tokens: int
    paged_planes: tuple = ()
    seq_planes: tuple = ()
    kernel: str = "dense"       # ragged kernel entry: dense | int8 | mla | none

    @property
    def token_group_bytes(self) -> int:
        """Bytes one pooled token occupies across ALL layers and planes."""
        return self.num_layers * sum(p.entry_bytes for p in self.paged_planes)

    @property
    def page_group_bytes(self) -> int:
        """Bytes one page GROUP occupies: the unit every spill/fault moves
        and every ``pool_d2h_bytes``/``pool_h2d_bytes`` counter charges."""
        return self.token_group_bytes * self.page_tokens

    def plane_page_bytes(self, plane: PlaneSpec) -> int:
        """One plane's share of a page group (all layers)."""
        return self.num_layers * self.page_tokens * plane.entry_bytes

    @property
    def seq_state_bytes(self) -> int:
        """Bytes of one sequence's state rows across layers and planes."""
        return self.num_layers * sum(p.entry_bytes for p in self.seq_planes)

    @property
    def has_pages(self) -> bool:
        return bool(self.paged_planes)

    @property
    def has_state(self) -> bool:
        return bool(self.seq_planes)

    def with_kv_dtype(self, dtype) -> "CacheDescriptor":
        """Descriptor with ``kind == 'kv'`` planes re-typed (the
        ``init_pool(dtype=...)`` override; scale/state planes keep theirs)."""
        dt = dtype_name(dtype)
        planes = tuple(
            PlaneSpec(p.name, p.shape, dt, p.kind) if p.kind == "kv" else p
            for p in self.paged_planes)
        return CacheDescriptor(self.family, self.num_layers, self.page_tokens,
                               planes, self.seq_planes, self.kernel)


# ---------------------------------------------------------------------------
# Family registry: (name, predicate, build function) walked in order; first
# match wins. A build function returns (paged_planes, seq_planes, kernel).
# ---------------------------------------------------------------------------
def _dense_planes(cfg, kv_cache_dtype, compute_dtype):
    dt = dtype_name(compute_dtype)
    K, D = cfg.num_kv_heads, cfg.head_dim
    return ((PlaneSpec("k", (K, D), dt), PlaneSpec("v", (K, D), dt)),
            (), "dense")


def _int8_planes(cfg, kv_cache_dtype, compute_dtype):
    K, D = cfg.num_kv_heads, cfg.head_dim
    return ((PlaneSpec("k", (K, D), "int8"),
             PlaneSpec("v", (K, D), "int8"),
             PlaneSpec("k_scale", (K,), "bfloat16", kind="scale"),
             PlaneSpec("v_scale", (K,), "bfloat16", kind="scale")),
            (), "int8")


def _mla_planes(cfg, kv_cache_dtype, compute_dtype):
    dt = dtype_name(compute_dtype)
    m = cfg.mla
    return ((PlaneSpec("c", (m.kv_lora_rank,), dt),
             PlaneSpec("kr", (m.qk_rope_head_dim,), dt)),
            (), "mla")


def _ssm_planes(cfg, kv_cache_dtype, compute_dtype):
    dt = dtype_name(compute_dtype)
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.ngroups * s.d_state
    return ((),
            (PlaneSpec("conv", (s.d_conv - 1, conv_dim), dt, kind="state"),
             PlaneSpec("ssm", (nheads, s.head_dim, s.d_state), "float32",
                       kind="state")),
            "none")


def _is_attn(cfg):
    return cfg.family in ("attn_dense", "vlm", "moe")


_FAMILY_BUILDERS: tuple = (
    ("mla", lambda cfg, kd: _is_attn(cfg) and cfg.mla is not None,
     _mla_planes),
    ("int8", lambda cfg, kd: _is_attn(cfg) and cfg.mla is None
     and kd == "int8" and cfg.family != "moe", _int8_planes),
    ("dense", lambda cfg, kd: _is_attn(cfg) and cfg.mla is None,
     _dense_planes),
    ("ssm", lambda cfg, kd: cfg.family == "ssm", _ssm_planes),
    # hybrid (interleaved SSM + shared-attention KV) and encdec (cross-KV)
    # have no pooled layout: no entry → None, the dense mirror
)


def descriptor_for(cfg, kv_cache_dtype: str = "native",
                   compute_dtype="float32",
                   page_tokens: int = 16) -> Optional[CacheDescriptor]:
    """Build the cache descriptor for a model config, or None when the
    family has no pooled layout (mirror-only)."""
    for fam, pred, build in _FAMILY_BUILDERS:
        if pred(cfg, kv_cache_dtype):
            paged, seq, kernel = build(cfg, kv_cache_dtype, compute_dtype)
            return CacheDescriptor(
                family=fam, num_layers=cfg.num_layers,
                page_tokens=page_tokens, paged_planes=paged,
                seq_planes=seq, kernel=kernel)
    return None


def dense_descriptor(num_layers: int, kv_heads: int, head_dim: int,
                     page_tokens: int, dtype="float16") -> CacheDescriptor:
    """The dense ``(k, v)`` layout as a descriptor (``KVSpec`` without an
    explicit descriptor resolves to this)."""
    dt = dtype_name(dtype)
    return CacheDescriptor(
        family="dense", num_layers=num_layers, page_tokens=page_tokens,
        paged_planes=(PlaneSpec("k", (kv_heads, head_dim), dt),
                      PlaneSpec("v", (kv_heads, head_dim), dt)),
        kernel="dense")
