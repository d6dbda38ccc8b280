"""Three-term roofline from dry-run artifacts, scored against the H100.

The port's copy of the JAX package's ``roofline/analysis.py``, with the
same arithmetic. A reduced-depth run's totals are affine in the block
counts, f = out + Σ_b n_b·c_b; each family's sample plan makes the system
solvable:

    dense/vlm/ssm/moe(k=0)   L ∈ {1,2}
    moe(first_k_dense=1)     L ∈ {2,3}   (dense block folds into `out`)
    encdec                   L ∈ {1,2}   (enc+dec move together, both 24)
    hybrid                   (L,period) ∈ {(2,2),(2,1),(4,2)} → solve
                             (out, mamba, shared) exactly

The port's dry run counts every layer it runs (it loops layers in Python,
where XLA counts a scan body once), so the samples are not needed for the
counts to be whole; the plan is kept so the same artifacts give the same
totals as the reference's method. ``roofline_cell`` scores a cell against
:data:`~repro_torch.roofline.hw.H100`: compute at the bf16 tensor-core
peak, memory at the HBM3 rate, and collectives at one NVLink 4 rate,
``wire / H100.nvlink_bandwidth`` — a rank's ring sends its wire bytes one
way while it receives as many the other, each direction at 450 GB/s. That
is one tier: a mesh of 256 or 512 ranks spans nodes, whose network is
slower, so the collective term is a lower bound (ROADMAP §3).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.roofline.hw import H100

METRICS = ("flops", "bytes", "wire")


def _extract(artifact: dict) -> dict:
    cost = artifact.get("cost", {})
    return {
        "flops": float(cost.get("flops", 0.0)),
        "bytes": float(cost.get("bytes accessed", 0.0)),
        "wire": float(artifact.get("collectives", {})
                      .get("total_wire_bytes", 0.0)),
    }


def _load(art_dir: Path, tag: str) -> Optional[dict]:
    p = art_dir / f"{tag}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def sample_plan(cfg) -> list[dict]:
    """Reduced-depth compiles needed for this arch (layers/period args)."""
    if cfg.family == "hybrid":
        return [{"layers": 2, "period": 2}, {"layers": 2, "period": 1},
                {"layers": 4, "period": 2}]
    if cfg.family == "moe" and cfg.moe.first_k_dense:
        return [{"layers": 2}, {"layers": 3}]
    return [{"layers": 1}, {"layers": 2}]


def _counts(cfg, layers: int, period: Optional[int]) -> list[float]:
    """Block-count vector [1(out), primary blocks, (hybrid) shared]."""
    if cfg.family == "hybrid":
        p = period or max(layers // 2, 1)
        n_seg = layers // p
        return [1.0, float(layers), float(n_seg)]
    if cfg.family == "moe" and cfg.moe.first_k_dense:
        return [1.0, float(layers - cfg.moe.first_k_dense)]
    return [1.0, float(layers)]


def _full_counts(cfg) -> list[float]:
    if cfg.family == "hybrid":
        n_seg = cfg.num_layers // cfg.hybrid.shared_block_period
        return [1.0, float(cfg.num_layers), float(n_seg)]
    if cfg.family == "moe" and cfg.moe.first_k_dense:
        return [1.0, float(cfg.num_layers - cfg.moe.first_k_dense)]
    return [1.0, float(cfg.num_layers)]


def reconstruct_totals(arch: str, shape_name: str, art_dir: Path,
                       mesh: str = "pod") -> Optional[dict]:
    """Solve the affine system and evaluate at the full config's counts."""
    cfg = get_config(arch)
    plan = sample_plan(cfg)
    rows, rhs = [], []
    for s in plan:
        tag = f"{arch}__{shape_name}__{mesh}__L{s['layers']}"
        if s.get("period"):
            tag += f"P{s['period']}"
        art = _load(art_dir, tag)
        if art is None:
            continue            # tolerate a missing sample (min-norm lstsq)
        rows.append(_counts(cfg, s["layers"], s.get("period")))
        rhs.append(_extract(art))
    if len(rows) < 2:
        return None
    A = np.array(rows)
    full = np.array(_full_counts(cfg))
    out = {}
    for m in METRICS:
        y = np.array([r[m] for r in rhs])
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        out[m] = float(np.maximum(full @ coef, 0.0))
    return out


# ---------------------------------------------------------------------------
# Analytic per-device HBM streaming floor.
#
# The dry run's "bytes accessed" is *pre-fusion logical traffic* (every
# op's inputs and outputs, as XLA's cost_analysis counts it); it overcounts
# real HBM traffic (every intermediate counted as if materialized). We therefore
# report it as an upper bound and attribute the bottleneck with an analytic
# floor: weight reads (× microbatches, × 3 for fwd/bwd/remat-recompute in
# training), residual-stream traffic, optimizer state r/w, KV-cache reads.
# ---------------------------------------------------------------------------
def analytic_memory_bytes(cfg, shape, devices: int, mb: int) -> float:
    N = cfg.param_count()
    model_shards = 16
    if cfg.family == "moe":
        w_local = 2.0 * N / devices            # FSDP+EP: fully sharded
    elif cfg.family in ("ssm", "hybrid"):
        w_local = 2.0 * N                      # mixers replicated on model
    else:
        w_local = 2.0 * N / model_shards       # TP
    tokens_local = shape.tokens / devices
    L = cfg.num_layers + cfg.num_encoder_layers
    act = 2.0 * tokens_local * cfg.d_model * 2 * max(L, 1)   # r+w per layer
    if shape.kind == "train":
        opt = 14.0 * N / devices               # master+mu+nu+grads r/w (≈)
        return mb * 3.0 * w_local + 3.0 * act + opt
    if shape.kind == "prefill":
        return w_local + act
    # decode: weights once + the KV cache read once per token
    S, B = shape.seq_len, shape.global_batch
    if cfg.family == "ssm":
        kv = 0.0
    elif cfg.mla is not None:
        m = cfg.mla
        kv = B * S * (m.kv_lora_rank + m.qk_rope_head_dim) * 2 * cfg.num_layers
    elif cfg.family == "hybrid":
        n_inv = cfg.num_layers // cfg.hybrid.shared_block_period
        kv = B * S * 2 * cfg.num_kv_heads * cfg.head_dim * 2 * n_inv
    else:
        kv = B * S * 2 * cfg.num_kv_heads * cfg.head_dim * 2 * cfg.num_layers
    return w_local + kv / devices


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (cluster-wide useful flops for the cell)
# ---------------------------------------------------------------------------
def _ssd_flops_per_token_layer(cfg) -> float:
    """Mamba-2 SSD useful work: within-chunk quadratic + state update.
    ≈ 4·Q·d_inner (CB/L/y_diag einsums) + 2·Q·N + state terms."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return 4.0 * s.chunk_size * d_inner + 2.0 * s.chunk_size * s.d_state \
        + 4.0 * d_inner * s.d_state


def model_flops(cfg, shape) -> float:
    n_active = cfg.active_param_count()
    S, B = shape.seq_len, shape.global_batch
    if cfg.frontend.kind == "vision" and shape.kind != "decode":
        S = S + cfg.frontend.num_tokens    # image prefix runs the backbone
    L = cfg.num_layers
    H, Dh = max(cfg.num_heads, 1), max(cfg.head_dim, 1)
    enc_frames = 4096                      # stub audio frontend length
    ssd = 0.0
    if cfg.ssm is not None and shape.kind != "decode":
        n_mamba = L if cfg.family == "ssm" else (
            L)                             # hybrid: all backbone layers
        mult = 3.0 if shape.kind == "train" else 1.0
        ssd = mult * _ssd_flops_per_token_layer(cfg) * S * B * n_mamba
    if shape.kind == "train":
        tokens = S * B
        attn = 3 * 4 * (S / 2) * H * Dh * tokens * L   # fwd+bwd causal attn
        if cfg.family == "encdec":
            # encoder sees 4096 frames, not S; cross-attn is S×4096
            enc_t = enc_frames * B
            attn = 3 * 4 * H * Dh * (
                (S / 2) * tokens * L          # decoder self-attn
                + enc_frames * tokens * L     # cross-attn (kv = enc frames)
                + enc_frames * enc_t * cfg.num_encoder_layers)
            # ≈ half the params in each stack; each sees its own tokens
            return 6.0 * n_active * 0.5 * (tokens + enc_t) + attn
        return 6.0 * n_active * tokens + ssd + (
            attn if cfg.family not in ("ssm",) else 0.0)
    if shape.kind == "prefill":
        tokens = S * B
        attn = 4 * (S / 2) * H * Dh * tokens * L
        if cfg.family == "encdec":
            enc_t = enc_frames * B
            attn = 4 * H * Dh * ((S / 2) * tokens * L
                                 + enc_frames * tokens * L
                                 + enc_frames * enc_t * cfg.num_encoder_layers)
            return 2.0 * n_active * 0.5 * (tokens + enc_t) + attn
        return 2.0 * n_active * tokens + ssd + (
            attn if cfg.family not in ("ssm",) else 0.0)
    # decode: one token per sequence against an S-token cache
    tokens = B
    if cfg.family == "ssm":
        attn = 0.0
    elif cfg.family == "hybrid":
        n_inv = cfg.num_layers // cfg.hybrid.shared_block_period
        attn = 4 * S * H * Dh * tokens * n_inv
    elif cfg.mla is not None:
        m = cfg.mla
        attn = 2 * S * H * (m.qk_nope_head_dim + m.qk_rope_head_dim
                            + m.v_head_dim) * tokens * L
    else:
        attn = 4 * S * cfg.num_kv_heads * Dh * tokens * L \
            * (cfg.num_heads / max(cfg.num_kv_heads, 1))
    return 2.0 * n_active * tokens + attn


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float          # analytic streaming floor (bottleneck attribution)
    memory_hlo_s: float      # "bytes accessed" pre-fusion upper bound
    collective_s: float
    bound: str
    model_flops_ratio: float
    fits_hbm: bool
    live_gb: float
    note: str = ""

    def as_dict(self):
        return self.__dict__.copy()


def roofline_cell(arch: str, shape_name: str, art_dir: Path,
                  mesh: str = "pod") -> Optional[RooflineRow]:
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    totals = reconstruct_totals(arch, shape_name, art_dir, mesh)
    full_art = _load(art_dir, f"{arch}__{shape_name}__{mesh}")
    if totals is None or full_art is None:
        return None
    n_dev = 512 if mesh == "multipod" else 256
    mb = full_art.get("microbatches", 1)
    t_c = totals["flops"] / H100.peak_flops_bf16
    t_m = analytic_memory_bytes(cfg, shape, n_dev, mb) / H100.hbm_bandwidth
    t_m_hlo = totals["bytes"] / H100.hbm_bandwidth
    # one NVLink tier: a lower bound for a mesh that spans nodes
    t_x = totals["wire"] / H100.nvlink_bandwidth
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bound = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_cluster_flops = totals["flops"] * n_dev
    ratio = mf / hlo_cluster_flops if hlo_cluster_flops else 0.0
    return RooflineRow(
        arch=arch, shape=shape_name, mesh=mesh,
        compute_s=t_c, memory_s=t_m, memory_hlo_s=t_m_hlo,
        collective_s=t_x, bound=bound,
        model_flops_ratio=ratio,
        fits_hbm=bool(full_art.get("fits_hbm")),
        live_gb=full_art.get("per_device_live_bytes", 0) / 1e9)


def render_table(rows: list[RooflineRow]) -> str:
    hdr = ("| arch | shape | compute s | memory s (floor) | memory s (HLO ub)"
           " | collective s | bound | useful/HLO flops | fits HBM | live GB |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r.arch} | {r.shape} | {r.compute_s:.4f} | {r.memory_s:.4f} "
            f"| {r.memory_hlo_s:.3f} | {r.collective_s:.4f} | **{r.bound}** "
            f"| {r.model_flops_ratio:.2f} | {'✓' if r.fits_hbm else '✗'} "
            f"| {r.live_gb:.1f} |")
    return "\n".join(lines)
