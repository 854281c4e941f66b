"""Mamba2 block via SSD (state-space duality, arXiv:2405.21060)
(counterpart of ``repro.models.ssm``).

Chunked algorithm: within chunks of length Q the dual (attention-like)
quadratic form; across chunks a linear recurrence over the [H, N, P]
states, a loop over the chunks.  Decode is the O(1)-per-token recurrent
update.

Conventions (inclusive-cumsum): h_t = exp(a_t) h_{t-1} + dt_t B_t (x) x_t,
y_t = C_t . h_t + D x_t,  a_t = dt_t * A_h.  ngroups == 1 (B/C shared
across heads).  Everything from the split of B, C and dt on runs in
float32 and is cast back to the input's dtype before the gated norm.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Draw, dense_init, rmsnorm


def ssm_dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.headdim
    conv_ch = d_inner + 2 * s.state
    return d_inner, H, conv_ch


def ssm_params(draw: Draw, cfg: ArchConfig):
    s = cfg.ssm
    d_inner, H, conv_ch = ssm_dims(cfg)
    return {
        "in_proj": dense_init(draw, cfg.d_model,
                              2 * d_inner + 2 * s.state + H),
        "conv_w": draw.normal((s.conv_width, 1, conv_ch), 0.1),
        "conv_b": draw.full((conv_ch,), 0.0),
        "A_log": draw.full((H,), 0.0, torch.float32),
        "D": draw.full((H,), 1.0, torch.float32),
        "dt_bias": draw.full((H,), 0.0, torch.float32),
        "norm_w": draw.full((d_inner,), 1.0),
        "out_proj": dense_init(draw, d_inner, cfg.d_model),
    }


def _split_proj(p, x, cfg: ArchConfig):
    s = cfg.ssm
    d_inner, H, _ = ssm_dims(cfg)
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner: 2 * d_inner + 2 * s.state]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * s.state:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    return z, xBC, dt


def _causal_conv(p, xBC, cfg: ArchConfig):
    """Depthwise causal convolution over time (a cross-correlation, as
    XLA's), accumulated in float32, then SiLU."""
    w, T = cfg.ssm.conv_width, xBC.shape[1]
    pad = F.pad(xBC, (0, 0, w - 1, 0)).float()
    cw = p["conv_w"][:, 0, :].to(xBC.dtype).float()
    out = pad[:, 0:T] * cw[0]
    for i in range(1, w):
        out = out + pad[:, i:i + T] * cw[i]
    return F.silu(out.to(xBC.dtype) + p["conv_b"].to(xBC.dtype))


def ssm_apply(p, x, *, cfg: ArchConfig, state: Optional[dict] = None):
    """Full-sequence SSD.  x [B, T, D], padded with zeros to a multiple of
    the chunk.

    Returns (y [B, T, D], final_state dict) — the state seeds decode.  As
    in the reference, the final state and the conv tail are those of the
    padded sequence.
    """
    s = cfg.ssm
    d_inner, H, conv_ch = ssm_dims(cfg)
    P, N, Q = s.headdim, s.state, s.chunk
    B_, T, _ = x.shape
    pad = (-T) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    Tp = x.shape[1]
    nc = Tp // Q

    z, xBC, dt = _split_proj(p, x, cfg)
    xBC = _causal_conv(p, xBC, cfg)
    xs = xBC[..., :d_inner].reshape(B_, Tp, H, P)
    Bm = xBC[..., d_inner: d_inner + N].float()                  # [B,T,N]
    Cm = xBC[..., d_inner + N:].float()                          # [B,T,N]

    A = -torch.exp(p["A_log"])                                   # [H]
    a = dt * A                                                   # [B,T,H]
    ac = a.reshape(B_, nc, Q, H)
    dtc = dt.reshape(B_, nc, Q, H)
    xc = xs.reshape(B_, nc, Q, H, P).float()
    Bc = Bm.reshape(B_, nc, Q, N)
    Cc = Cm.reshape(B_, nc, Q, N)
    cum = ac.cumsum(2)                                           # inclusive

    # ---- intra-chunk (dual quadratic form) ----
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)                 # [B,nc,Q,Q]
    # the mask goes on the exponent (exp(-inf) = 0), not on the decay as
    # in the reference: above the diagonal cum[q] - cum[k] > 0 overflows
    # exp at full width, and the masked inf's backward is 0 x inf = NaN.
    # The forward values are the reference's.
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None],
                                  cum[:, :, :, None, :] - cum[:, :, None, :, :],
                                  float("-inf")))
    scores = CB[..., None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, xc)

    # ---- chunk states + inter-chunk recurrence ----
    last = cum[:, :, -1:, :]                                     # [B,nc,1,H]
    sdecay = torch.exp(last - cum)                               # [B,nc,Q,H]
    S_c = torch.einsum("bcqh,bcqn,bcqhp->bchnp", sdecay * dtc, Bc, xc)
    tot = torch.exp(last[:, :, 0, :])                            # [B,nc,H]

    h = (state["h"] if state is not None
         else x.new_zeros((B_, H, N, P), dtype=torch.float32))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)                                         # h_{c-1}
        h = tot[:, c, :, None, None] * h + S_c[:, c]
    h_prev = torch.stack(h_prev, 1)                              # [B,nc,H,N,P]
    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cc, torch.exp(cum),
                           h_prev)

    y = (y_intra + y_inter).reshape(B_, Tp, H, P)
    y = y + p["D"][None, None, :, None] * xc.reshape(B_, Tp, H, P)
    y = y.reshape(B_, Tp, d_inner).to(x.dtype)
    y = rmsnorm(y, p["norm_w"]) * F.silu(z)
    y = y @ p["out_proj"]
    if pad:
        y = y[:, :T]
    return y, {"h": h, "conv": xBC_raw_tail(p, x, cfg)}


def xBC_raw_tail(p, x, cfg: ArchConfig):
    """Last conv_width-1 pre-conv xBC rows (seed for decode's conv cache)."""
    s = cfg.ssm
    d_inner, H, conv_ch = ssm_dims(cfg)
    zxbcdt = x[:, -(s.conv_width - 1):, :] @ p["in_proj"]
    return zxbcdt[..., d_inner: d_inner + conv_ch]


def ssm_decode_step(p, x, state, *, cfg: ArchConfig):
    """One-token recurrent update.  x [B, 1, D]; state {h, conv}, updated
    in place and returned."""
    s = cfg.ssm
    d_inner, H, conv_ch = ssm_dims(cfg)
    P, N = s.headdim, s.state
    B_ = x.shape[0]

    z, xBC, dt = _split_proj(p, x, cfg)                          # xBC [B,1,ch]
    window = torch.cat([state["conv"], xBC], 1)                  # [B,w,ch]
    conv_out = ((window * p["conv_w"][:, 0, :].to(x.dtype)[None]).sum(
        1, keepdim=True) + p["conv_b"].to(x.dtype))
    conv_out = F.silu(conv_out)                                  # [B,1,ch]

    xs = conv_out[..., :d_inner].reshape(B_, H, P).float()
    Bm = conv_out[..., d_inner: d_inner + N][:, 0].float()
    Cm = conv_out[..., d_inner + N:][:, 0].float()
    A = -torch.exp(p["A_log"])
    dt1 = dt[:, 0]                                               # [B,H]
    decay = torch.exp(dt1 * A)                                   # [B,H]
    h = (decay[:, :, None, None] * state["h"]
         + torch.einsum("bh,bn,bhp->bhnp", dt1, Bm, xs))
    y = torch.einsum("bn,bhnp->bhp", Cm, h) + p["D"][None, :, None] * xs
    y = y.reshape(B_, 1, d_inner).to(x.dtype)
    y = rmsnorm(y, p["norm_w"]) * F.silu(z)
    y = y @ p["out_proj"]
    state["h"].copy_(h)
    state["conv"].copy_(window[:, 1:])
    return y, state
