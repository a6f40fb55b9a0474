"""Hand-rolled AdamW with a cosine schedule and global-norm clipping
(port of `repro.train.optimizer`).

This is the reference's arithmetic, not `torch.optim.AdamW`'s: `mu` and
`nu` are f32 for every parameter, norms and embeddings included, weight
decay applies to every leaf, and each update is computed in f32 and cast
back to the parameter's dtype. The state is keyed by parameter name (an
`LM`'s `named_parameters()`, or a dict's keys), and the step and the
learning rate stay tensors on the parameters' device, so an update reads
nothing back to the host.

The port updates the parameters and the moments in place; each function
still returns what the reference's returns, so callers read the same.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    step: torch.Tensor        # int32 scalar on the parameters' device


def named(params) -> dict:
    """{name: tensor} of an `nn.Module`'s parameters, or the dict itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """-> lr(step): linear warm-up over `warmup` steps, then a cosine decay
    to 0 at `total`; f32 arithmetic, as the reference's."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * (step + 1) / max(1, warmup)
        t = ((step - warmup) / max(1, total - warmup)).clamp(0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return lr


def adamw_init(params) -> AdamWState:
    """Zero f32 moments for every parameter, step 0."""
    params = named(params)
    mu = {k: torch.zeros_like(p, dtype=torch.float32)
          for k, p in params.items()}
    nu = {k: torch.zeros_like(m) for k, m in mu.items()}
    device = next(iter(params.values())).device
    return AdamWState(mu=mu, nu=nu,
                      step=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


def clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor `clip_by_global_norm` multiplies each leaf by."""
    return torch.clamp(max_norm / gn.clamp_min(1e-9), max=1.0)


def clip_by_global_norm(tree: dict, max_norm: float):
    """-> ({name: f32 leaf x scale}, the global norm); scale = min(1,
    max_norm / norm). `make_train_step` folds the scale into each
    leaf's update instead (`adamw_update(grad_scale=)`), the same
    arithmetic without an f32 copy of every gradient at once."""
    gn = global_norm(tree)
    scale = clip_scale(gn, max_norm)
    return {k: g.float() * scale for k, g in tree.items()}, gn


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params, lr_fn,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_scale: torch.Tensor | None = None):
    """One AdamW step over every named parameter -> (params, state), both
    updated in place. `grad_scale`, where given, multiplies each f32
    gradient first (the clipping factor)."""
    step = state.step + 1
    lr = lr_fn(step)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in named(params).items():
        g = grads[name].float()
        if grad_scale is not None:
            g = g * grad_scale
        m, v = state.mu[name], state.nu[name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        pf = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    return params, AdamWState(mu=state.mu, nu=state.nu, step=step)
