"""Shared layers: RMSNorm and LayerNorm, rotary embeddings (RoPE and
Qwen2-VL's M-RoPE), gated and plain MLPs — the port of
`repro.models.layers`.

Layouts follow the reference: activations (..., S, d), heads
(..., S, H, hd). Weights are `nn.Linear`s, so `x @ W` of the reference
is `F.linear(x, W.T)` here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float) -> torch.Tensor:
    """f32 mean and population variance (`jnp.var`); the normalised
    value is cast back before the affine, as in the reference."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def apply_norm(cfg, norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, norm.w, norm.b, cfg.norm_eps)
    return rmsnorm(x, norm.w, cfg.norm_eps)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, hd); positions (..., S) -> rotated x (half-split
    form, angles in f32)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs             # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the hd/2 frequency lanes split into (t, h, w)
    sections, each rotated by its own position stream. x (B, S, H, hd);
    positions3 (3, B, S). With three equal streams it is `apply_rope`
    bit for bit."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    freqs = rope_freqs(hd, theta, x.device)
    # which position stream drives each frequency lane
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)
    pos = positions3[sec_id]                               # (hd/2, B, S)
    ang = pos.movedim(0, -1).float() * freqs               # (B, S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class Norm(nn.Module):
    """A norm's weight `w` and, for LayerNorm, its bias `b` (named as the
    reference's leaf: the converter maps a leaf named `bias` to a
    projection's `b<name>`)."""

    def __init__(self, cfg, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.w = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        if cfg.norm == "layernorm":
            self.b = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))


class MLP(nn.Module):
    """SwiGLU / GeGLU (gate and up projections) or plain GELU."""

    def __init__(self, cfg, device, dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.act = cfg.act
        if cfg.act in ("swiglu", "geglu"):
            self.w_gate = nn.Linear(d, f, bias=False, device=device,
                                    dtype=dtype)
        self.w_up = nn.Linear(d, f, bias=False, device=device, dtype=dtype)
        self.w_down = nn.Linear(f, d, bias=False, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act == "swiglu":
            h = F.silu(self.w_gate(x)) * self.w_up(x)
        elif self.act == "geglu":
            # jax.nn.gelu(approximate=True) is the tanh form
            h = F.gelu(self.w_gate(x), approximate="tanh") * self.w_up(x)
        else:
            h = F.gelu(self.w_up(x), approximate="tanh")
        return self.w_down(h)
