"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060].

The counterparts of the JAX package's ``models/ssm.py``, function by
function: the chunked scan over a whole sequence (:func:`ssd_chunked`,
a within-chunk quadratic term plus an inter-chunk state recurrence, here
a Python loop over chunks where the reference runs ``lax.scan``), the
full-sequence block (:func:`apply_ssm`) and the single-token step
(:func:`ssm_decode`) that carries ``(conv_state, ssm_state)`` exactly.

The reference computes all of it in XLA (no Pallas kernel), so these are
plain torch ops. The causal depthwise conv is the reference's window sum
(``einsum("kbtc,kc->btc")``), not ``conv1d``, whose library kernels may
sum in another order or in TF32. ``p`` is the mixer's parameter holder
(:class:`~repro_torch.models.blocks.SSMBlock`): ``in_proj``, ``conv_w``,
``conv_b``, ``dt_bias``, ``a_log``, ``d_skip``, ``norm_scale`` and
``out_proj``, all in the compute dtype (the reference casts every weight
to it, the fp32 ``dt_bias``/``a_log``/``d_skip`` too).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.ngroups * s.d_state
    return s, d_inner, nheads, conv_dim


def mixer_shapes(cfg) -> dict:
    """The mixer's parameter name → shape (the JAX ``init_ssm`` pytree's
    keys; matrices in its ``(d_in, d_out)`` layout)."""
    s, d_inner, nheads, conv_dim = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * s.ngroups * s.d_state + nheads
    return {"in_proj": (cfg.d_model, d_in_proj),
            "conv_w": (s.d_conv, conv_dim),
            "conv_b": (conv_dim,),
            "dt_bias": (nheads,),
            "a_log": (nheads,),
            "d_skip": (nheads,),
            "norm_scale": (d_inner,),
            "out_proj": (d_inner, cfg.d_model)}


def init_mixer_(p, cfg, generator) -> None:
    """Draw the mixer's weights in place with the reference's
    distributions: truncated-normal projections (``std = 1/sqrt(fan_in)``),
    a ``0.1``-scaled normal conv, ``dt_bias`` the inverse softplus of a
    log-uniform step in [1e-3, 1e-1], ``a_log = log(1..H)``, unit skip and
    norm scale, zero conv bias."""
    from repro_torch.models.layers import truncated_normal_
    _, _, nheads, _ = _dims(cfg)
    dev = p.in_proj.device
    truncated_normal_(p.in_proj, 1.0, generator)
    truncated_normal_(p.out_proj, 1.0, generator)
    with torch.no_grad():
        w = torch.randn(p.conv_w.shape, generator=generator, device=dev)
        p.conv_w.copy_(w * 0.1)
        p.conv_b.zero_()
        u = torch.rand((nheads,), generator=generator, device=dev)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3))
                       + math.log(1e-3))
        p.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        p.a_log.copy_(torch.log(torch.arange(1, nheads + 1, device=dev,
                                             dtype=torch.float32)))
        p.d_skip.fill_(1.0)
        p.norm_scale.fill_(1.0)


def _split_in_proj(cfg, zxbcdt):
    _, d_inner, _, conv_dim = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, conv_dim,
                                zxbcdt.shape[-1] - d_inner - conv_dim],
                       dim=-1)


def _gated_norm(p, y, z, eps):
    yf = y.float() * F.silu(z.float())
    var = yf.square().mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * p.norm_scale.float()).to(y.dtype)


def _segsum(x):
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] (i>=j),
    -inf above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, A, B, C, chunk_size, initial_state=None):
    """SSD over a full sequence, chunk by chunk.

    x: (b, T, H, P) per-head inputs; dt: (b, T, H) positive steps (already
    softplus'd); A: (H,) negative; B, C: (b, T, N) shared across heads
    (ngroups 1). Returns ``(y (b, T, H, P) in x's dtype, final_state
    (b, H, P, N) fp32)``. Live memory is one chunk's quadratic term
    (b·H·Q²)."""
    b, T, H, P = x.shape
    N = B.shape[-1]
    Q = chunk_size
    if T % Q:
        raise ValueError(f"seq {T} not divisible by chunk {Q}")
    nc = T // Q
    xd = (x * dt[..., None]).float()                           # fold dt in
    dA = (dt * A[None, None, :]).float()                       # (b,T,H) ≤ 0
    xc = xd.reshape(b, nc, Q, H, P)
    Bc = B.reshape(b, nc, Q, N).float()
    Cc = C.reshape(b, nc, Q, N).float()
    dAc = dA.reshape(b, nc, Q, H)
    s = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for c in range(nc):
        xj, Bj, Cj, dAj = xc[:, c], Bc[:, c], Cc[:, c], dAc[:, c]
        L = torch.exp(_segsum(dAj.transpose(1, 2)))            # (b,H,Q,Q)
        CB = torch.einsum("bin,bjn->bij", Cj, Bj)              # (b,Q,Q)
        y_diag = torch.einsum("bij,bhij,bjhp->bihp", CB, L, xj)
        dA_cum = torch.cumsum(dAj, dim=1)                      # (b,Q,H)
        decay_to_end = torch.exp(dA_cum[:, -1:, :] - dA_cum)
        state_c = torch.einsum("bjn,bjh,bjhp->bhpn", Bj, decay_to_end, xj)
        y_off = torch.einsum("bin,bih,bhpn->bihp", Cj, torch.exp(dA_cum), s)
        s = s * torch.exp(dA_cum[:, -1, :])[:, :, None, None] + state_c
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(b, T, H, P)
    return y.to(x.dtype), s


def apply_ssm(p, cfg, x, initial_state=None):
    """Full-sequence Mamba-2 mixer. x: (B, T, d_model). Returns
    ``(y, (conv_state (B, d_conv-1, conv_dim), ssm_state (B, H, P, N)
    fp32))`` — the states a decode continues from. ``T`` pads up to a
    chunk multiple with ``dt = 0`` (decay 1, update 0): padded steps
    change neither the outputs nor the final state."""
    s, d_inner, nheads, _ = _dims(cfg)
    B_, T, _ = x.shape
    z, xbc, dt = _split_in_proj(cfg, x @ p.in_proj)
    # causal depthwise conv over xbc: the reference's window sum
    xbc_pad = F.pad(xbc, (0, 0, s.d_conv - 1, 0))
    win = torch.stack([xbc_pad[:, i:i + T] for i in range(s.d_conv)], 0)
    xbc = F.silu(torch.einsum("kbtc,kc->btc", win, p.conv_w) + p.conv_b)
    conv_state = xbc_pad[:, -(s.d_conv - 1):]
    xs, Bmat, Cmat = torch.split(
        xbc, [d_inner, s.ngroups * s.d_state, s.ngroups * s.d_state], dim=-1)
    xh = xs.reshape(B_, T, nheads, s.head_dim)
    dt = F.softplus(dt.float() + p.dt_bias[None, None, :])     # (B,T,H)
    A = -torch.exp(p.a_log)                                    # (H,)
    Q = s.chunk_size
    T_pad = (-T) % Q
    if T_pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, T_pad))
        Bmat = F.pad(Bmat, (0, 0, 0, T_pad))
        Cmat = F.pad(Cmat, (0, 0, 0, T_pad))
        dt = F.pad(dt, (0, 0, 0, T_pad))
    y, final_state = ssd_chunked(xh, dt, A, Bmat, Cmat, Q, initial_state)
    if T_pad:
        y, xh = y[:, :T], xh[:, :T]
    y = y + p.d_skip[None, None, :, None] * xh.float()
    y = y.reshape(B_, T, d_inner).to(x.dtype)
    y = _gated_norm(p, y, z, cfg.norm_eps)
    return y @ p.out_proj, (conv_state, final_state)


def ssm_decode(p, cfg, x, conv_state, ssm_state):
    """Single-token step. x: (B, 1, d); conv_state (B, d_conv-1,
    conv_dim); ssm_state (B, H, P, N) fp32. Returns ``(y, (new_conv_state,
    new_ssm_state))`` as new tensors (the inputs are left as they are)."""
    s, d_inner, nheads, _ = _dims(cfg)
    B_ = x.shape[0]
    z, xbc_new, dt = _split_in_proj(cfg, x @ p.in_proj)       # (B,1,·)
    window = torch.cat([conv_state, xbc_new], dim=1)           # (B,d_conv,c)
    new_conv_state = window[:, 1:]
    xbc = F.silu(torch.einsum("bkc,kc->bc", window, p.conv_w)
                 + p.conv_b)[:, None, :]
    xs, Bmat, Cmat = torch.split(
        xbc, [d_inner, s.ngroups * s.d_state, s.ngroups * s.d_state], dim=-1)
    xh = xs.reshape(B_, nheads, s.head_dim).float()
    dt = F.softplus(dt[:, 0].float() + p.dt_bias[None, :])     # (B,H)
    A = -torch.exp(p.a_log)
    dA = torch.exp(dt * A[None, :])                            # (B,H)
    Bv = Bmat[:, 0].float()                                    # (B,N)
    Cv = Cmat[:, 0].float()
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xh, Bv)
    new_state = ssm_state * dA[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cv)
    y = y + p.d_skip[None, :, None] * xh
    y = y.reshape(B_, 1, d_inner).to(x.dtype)
    y = _gated_norm(p, y, z, cfg.norm_eps)
    return y @ p.out_proj, (new_conv_state, new_state)
