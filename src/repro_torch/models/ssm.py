"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) in chunked
matmul form, plus the O(1) single-token decode step (port of
`repro.models.ssm`).

The chunked SSD algorithm turns the linear recurrence
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,   y_t = C_t h_t + D x_t
into (1) intra-chunk "attention" with a causal decay kernel, (2) per-chunk
state summaries, (3) an inter-chunk scan, (4) state-to-output corrections
— all dense products except the short chunk-level scan.

The reference writes the products as multi-operand `einsum`s, whose
contraction order depends on the planner installed; here each is a
`torch.matmul` of two operands in a fixed order, the heads of one B/C
group folded into the rows, so no (.., H, L, N) copy of B or C is made.
The SSD and the decode step run in plain PyTorch, as the reference's run
in plain jnp outside any Pallas kernel. Parameters keep the reference's
leaves and layouts, for `x @ W`: `A_log`, `dt_bias` and `D` in f32, the
rest in the model dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import rmsnorm

CHUNK = 256


class Mamba2(nn.Module):
    def __init__(self, cfg, device, dtype):
        super().__init__()
        d, din = cfg.d_model, cfg.d_inner
        g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        conv_ch = din + 2 * g * n

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dt))

        self.in_proj = param(d, 2 * din + 2 * g * n + h)
        self.conv_w = param(cfg.ssm_conv, conv_ch)
        self.conv_b = param(conv_ch)
        self.A_log = param(h, dt=torch.float32)
        self.dt_bias = param(h, dt=torch.float32)
        self.D = param(h, dt=torch.float32)
        self.out_norm = param(din)
        self.out_proj = param(din, d)


def _split_proj(cfg, zxbcdt):
    """-> (z, xbc = [x, B, C] before the convolution, dt_raw)."""
    din, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    return torch.split(zxbcdt, [din, din + 2 * g * n, cfg.ssm_heads],
                       dim=-1)


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over time, in xbc's dtype. xbc (B, S, Ch);
    w (K, Ch)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(k))
    return F.silu(out + b)


def _segsum(a):
    """a (..., L) -> (..., L, L): cumsum differences, -inf above the
    diagonal (the reference's form, not a 'stable' variant)."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return diff.masked_fill_(~mask, -torch.inf)


def ssd_chunked(x, dt, a, b, c, chunk: int = CHUNK, h0=None):
    """Chunked SSD scan.

    x (B, S, H, P); dt (B, S, H); a (H,) negative; b, c (B, S, G, N).
    Returns (y (B, S, H, P), h_final (B, H, P, N)). S must be a multiple
    of `chunk` (the reference asserts it; here it raises).
    """
    bs, s, nh, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence {s} is not a multiple of "
                         f"the chunk {chunk}")
    nc, rep, l = s // chunk, nh // g, chunk

    # heads grouped by their B/C group: (B, C, G, rep, L, P)
    xz = (x * dt[..., None]).reshape(bs, nc, l, g, rep, p)
    xz = xz.permute(0, 1, 3, 4, 2, 5)
    a_perm = (dt * a).reshape(bs, nc, l, nh).transpose(-1, -2)  # (B,C,H,L)
    a_cum = torch.cumsum(a_perm, dim=-1)
    bz = b.reshape(bs, nc, l, g, n).transpose(2, 3)           # (B,C,G,L,N)
    cz = c.reshape(bs, nc, l, g, n).transpose(2, 3)

    # (1) intra-chunk: y[l] = sum_s (C_l . B_s) exp(segsum)[l, s] x_s
    # (in place unless autograd records: at 2 x 24,576 tokens and 64
    # heads one (B,C,H,L,L) f32 tensor is 3.2 GB; recorded, out of
    # place, as the backward of exp keeps its output)
    cb = (cz @ bz.transpose(-1, -2))[:, :, :, None]           # (B,C,G,1,L,L)
    seg = _segsum(a_perm).reshape(bs, nc, g, rep, l, l)
    if seg.requires_grad or cb.requires_grad:
        ll = seg.exp() * cb
    else:
        ll = seg.exp_().mul_(cb)
    y_diag = ll @ xz                                          # (B,C,G,r,L,P)
    del ll, seg

    # (2) chunk state summaries: sum_l decay_l x_l B_l^T -> (B,C,H,P,N)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum).reshape(
        bs, nc, g, rep, l, 1)
    xd = (xz * decay_states).transpose(-1, -2).reshape(bs, nc, g, rep * p, l)
    states = (xd @ bz).reshape(bs, nc, nh, p, n)

    # (3) inter-chunk recurrence (a short scan over the chunk count)
    chunk_decay = torch.exp(a_cum[..., -1])                   # (B,C,H)
    h = (torch.zeros((bs, nh, p, n), dtype=x.dtype, device=x.device)
         if h0 is None else h0)
    prev = []
    for ci in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                    # (B,C,H,P,N)

    # (4) state -> output: y[l] = exp(a_cum_l) C_l . h_prev
    hp = prev_states.reshape(bs, nc, g, rep * p, n).transpose(-1, -2)
    y_off = (cz @ hp).reshape(bs, nc, g, l, rep, p).transpose(3, 4)
    y_off = y_off * torch.exp(a_cum).reshape(bs, nc, g, rep, l, 1)

    y = (y_diag + y_off).permute(0, 1, 4, 2, 3, 5).reshape(bs, s, nh, p)
    return y, h


def _ssd_inputs(cfg, p: Mamba2, xbc, dt_raw):
    """The post-convolution channels and dt as the SSD takes them, f32:
    -> (xh (B, S, H, P), dt (B, S, H), a (H,), b, c (B, S, G, N))."""
    bs, s, _ = xbc.shape
    g, n = cfg.ssm_groups, cfg.ssm_state
    xs, b, c = torch.split(xbc, [cfg.d_inner, g * n, g * n], dim=-1)
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    a = -torch.exp(p.A_log)
    xh = xs.reshape(bs, s, cfg.ssm_heads, cfg.ssm_head_dim).float()
    return (xh, dt, a, b.reshape(bs, s, g, n).float(),
            c.reshape(bs, s, g, n).float())


def _out(cfg, p: Mamba2, y, xh, z, dtype):
    """D skip, gate, norm and output projection: y (B, S, H, P) f32."""
    bs, s = y.shape[:2]
    y = y + xh * p.D[:, None]
    y = y.reshape(bs, s, cfg.d_inner).to(dtype)
    y = rmsnorm(y * F.silu(z), p.out_norm, cfg.norm_eps)
    return y @ p.out_proj


def mamba2_prefill(cfg, p: Mamba2, x: torch.Tensor):
    """Full-sequence forward that also returns decode-ready state.

    -> (y (B, S, d), {"ssm": (B, H, P, N) f32, "conv": (B, K-1, Ch) in
    the model dtype})
    """
    z, xbc_raw, dt_raw = _split_proj(cfg, x @ p.in_proj)
    xbc = _causal_conv(xbc_raw, p.conv_w, p.conv_b)
    xh, dt, a, b, c = _ssd_inputs(cfg, p, xbc, dt_raw)
    y, h_last = ssd_chunked(xh, dt, a, b, c, chunk=min(CHUNK, x.shape[1]))
    out = _out(cfg, p, y, xh, z, x.dtype)
    conv = xbc_raw[:, -(cfg.ssm_conv - 1):, :].to(getattr(torch, cfg.dtype))
    return out, {"ssm": h_last.float(), "conv": conv}


def mamba2_forward(cfg, p: Mamba2, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba-2 mixer. x (B, S, d) -> (B, S, d)."""
    return mamba2_prefill(cfg, p, x)[0]


def mamba2_decode_state_shapes(cfg, batch: int) -> dict:
    """One layer's decode state: name -> (shape, dtype)."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return dict(
        ssm=((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
             torch.float32),
        conv=((batch, cfg.ssm_conv - 1, conv_ch), getattr(torch, cfg.dtype)),
    )


def mamba2_decode(cfg, p: Mamba2, x1: torch.Tensor, state: dict):
    """O(1) decode step. x1 (B, 1, d); state {ssm, conv}, one layer's,
    updated in place (the reference returns new arrays) -> y (B, 1, d).
    The convolution runs in f32 over the history kept in the model
    dtype, as in the reference."""
    bs = x1.shape[0]
    z, xbc, dt_raw = _split_proj(cfg, x1 @ p.in_proj)
    conv = state["conv"]
    hist = torch.cat([conv, xbc.to(conv.dtype)], dim=1)       # (B, K, Ch)
    conv_out = (hist.float() * p.conv_w.float()).sum(1) + p.conv_b
    xbc1 = F.silu(conv_out)[:, None, :].to(x1.dtype)
    conv.copy_(hist[:, 1:])

    xh, dt, a, b, c = _ssd_inputs(cfg, p, xbc1, dt_raw)
    xh, dt = xh[:, 0], dt[:, 0]                               # (B,H,P), (B,H)
    rep = cfg.ssm_heads // cfg.ssm_groups
    bh = b[:, 0].repeat_interleave(rep, dim=1)                # (B, H, N)
    ch = c[:, 0].repeat_interleave(rep, dim=1)
    ssm = state["ssm"]
    decay = torch.exp(dt * a)                                 # (B, H)
    ssm.mul_(decay[..., None, None]).add_(
        (dt[..., None] * xh)[..., None] * bh[:, :, None, :])
    y = (ssm @ ch[..., None])[..., 0]                         # (B, H, P)
    return _out(cfg, p, y[:, None], xh[:, None], z, x1.dtype)
