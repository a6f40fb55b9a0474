"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
`repro.models.moe`, the grouped single-device path).

Tokens are routed by a sorted permutation, so no expert has a dynamic
shape: each expert runs a dense (E, C, d) x (E, d, f) batched product
over its C capacity slots, and the results scatter-add back through the
same permutation. The products are `torch.bmm`, as the reference's are
`einsum` outside any Pallas kernel.

The reference's shard_map path (`_moe_shard_map`) needs a device mesh;
it comes with the port of `distributed/`. Here every call takes the
grouped path over `cfg.moe_dp_groups` token groups.

Parameters keep the reference's leaves and layouts, for `x @ W`: router
(d, E) in f32, w_gate and w_up (E, d, f), w_down (E, f, d) in the model
dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class MoE(nn.Module):
    def __init__(self, cfg, device, dtype):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dt))

        self.router = param(d, e, dt=torch.float32)
        self.w_gate = param(e, d, f)
        self.w_up = param(e, d, f)
        self.w_down = param(e, f, d)


def moe_capacity(cfg, tokens: int) -> int:
    """Slots an expert takes from a group of `tokens` tokens: the
    expected share times `capacity_factor`, rounded up to 8, at least 8."""
    cap = int(tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, ((cap + 7) // 8) * 8)


def _route(cfg, p: MoE, xt: torch.Tensor):
    """The router over a token group (T, d): -> (probs (T, E) f32, the
    top-k probabilities and their experts (T, k), largest first)."""
    probs = torch.softmax(xt.float() @ p.router, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.moe_top_k, dim=-1)
    return probs, top_p, top_e


def _dispatch_local(cfg, p: MoE, xt: torch.Tensor, c: int):
    """Route one token group (T, d) through the experts at capacity `c`.
    Returns (y (T, d) f32, aux f32 scalar)."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    dev = xt.device

    probs, top_p, top_e = _route(cfg, p, xt)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balancing auxiliary loss (Switch-style)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, top_e.reshape(-1),
        torch.full((t * k,), 1.0 / (t * k), dtype=torch.float32, device=dev))
    aux = e * (probs.mean(dim=0) * ce).sum()

    # token-expert pairs sorted by expert; a stable sort, as jnp.argsort,
    # so capacity drops keep the same pairs
    flat_e = top_e.reshape(-1)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], top_p.reshape(-1)[order]

    # each expert's contiguous slots (capacity c, overflow dropped); an
    # empty slot gathers token 0 and carries weight 0
    eid = torch.arange(e, device=dev)
    lo = torch.searchsorted(se, eid)
    hi = torch.searchsorted(se, eid, right=True)
    slot = lo[:, None] + torch.arange(c, device=dev)[None, :]
    valid = slot < hi[:, None]                               # (E, C)
    slot_c = slot.clamp(0, t * k - 1)
    tok = torch.where(valid, st[slot_c], 0)                  # (E, C)
    wgt = torch.where(valid, sw[slot_c], 0.0)

    xe = xt[tok] * valid[..., None].to(xt.dtype)             # (E, C, d)
    h = F.silu(torch.bmm(xe, p.w_gate)) * torch.bmm(xe, p.w_up)
    ye = torch.bmm(h, p.w_down)                              # (E, C, d)
    y = torch.zeros((t, d), dtype=torch.float32, device=dev).index_add_(
        0, tok.reshape(-1), (ye.float() * wgt[..., None]).reshape(-1, d))
    return y, aux


def moe_ffn(cfg, p: MoE, x: torch.Tensor):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux_loss f32 scalar).

    The tokens split into G = min(moe_dp_groups, B) groups, each routed
    on its own at the capacity of T / G tokens; aux is the groups'
    mean."""
    b, s, d = x.shape
    t = b * s
    g = max(1, min(cfg.moe_dp_groups, b))     # cannot split below 1 batch row
    c = moe_capacity(cfg, t // g)
    ys, auxs = zip(*(_dispatch_local(cfg, p, xt, c)
                     for xt in x.reshape(g, t // g, d)))
    return (torch.stack(ys).reshape(b, s, d).to(x.dtype),
            torch.stack(auxs).mean())
