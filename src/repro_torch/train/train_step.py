"""Train-step factory: forward, chunked cross-entropy, AdamW (port of
`repro.train.train_step`).

A step runs where the model's parameters lie: the batch is moved to that
device, and a model on the card trains there or raises; nothing falls
back to the CPU. The parameters are updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import runtime as RT
from repro_torch.models import lm
from repro_torch.train.loss import chunked_cross_entropy
from repro_torch.train.optimizer import (adamw_update, clip_scale,
                                         cosine_schedule, global_norm, named)

AUX_COEF = 0.01


def _on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _loss(cfg, model, batch: dict):
    """-> (ce + AUX_COEF * aux, ce, aux)."""
    hidden, aux = lm.forward(cfg, model, batch)
    ce = chunked_cross_entropy(hidden, model.lm_head.weight.T,
                               batch["labels"], cfg.vocab)
    return ce + AUX_COEF * aux, ce, aux


def value_and_grad(cfg, model, batch: dict):
    """-> (loss, ce, aux, {name: gradient of loss}) over one batch on the
    model's device; each gradient in its parameter's dtype (zeros for a
    parameter the batch does not reach). The reference's `grad_fn`."""
    params = named(model)
    batch = _on_device(batch, model.device)
    flags = {k: p.requires_grad for k, p in params.items()}
    try:
        for p in params.values():
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, ce, aux = _loss(cfg, model, batch)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
    finally:
        for k, p in params.items():
            p.requires_grad_(flags[k])
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    return loss.detach(), ce.detach(), aux.detach(), grads


def make_train_step(cfg, base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, grad_clip: float = 1.0,
                    accum_steps: int = 1):
    """-> train_step(model, opt_state, batch) -> (model, opt_state,
    metrics {"loss" (ce), "aux_loss", "grad_norm" (before clipping), "lr"
    (at the updated step)}, 0-d tensors on the model's device).

    On a mesh (DTensor parameters laid out by
    `distributed.sharding.param_pspecs`, moments by `zero1_pspecs`, the
    batch by `batch_pspecs`) the same step runs under `RT.spmd()`, and
    DTensor's propagation places the collectives.

    accum_steps > 1: the batch splits into `accum_steps` contiguous
    microbatches (along every entry whose first dimension is the batch)
    run one after another; their gradients, ce and aux add up in f32,
    each divided by `accum_steps`, so peak activation memory falls by
    that factor.
    """
    lr_fn = cosine_schedule(base_lr, warmup, total_steps)

    def train_step(model, opt_state, batch):
        with RT.spmd():
            return _step(model, opt_state, batch)

    def _step(model, opt_state, batch):
        if accum_steps == 1:
            _, ce, aux, grads = value_and_grad(cfg, model, batch)
        else:
            b = torch.as_tensor(batch["tokens"]).shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} does not split into "
                                 f"{accum_steps} microbatches")
            n = b // accum_steps
            batch = _on_device(batch, model.device)
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in named(model).items()}
            zero = torch.zeros((), dtype=torch.float32, device=model.device)
            ce, aux = zero, zero
            for i in range(accum_steps):
                mb = {k: v[i * n:(i + 1) * n]
                      if v.ndim >= 1 and v.shape[0] == b else v
                      for k, v in batch.items()}
                _, ce_i, aux_i, g = value_and_grad(cfg, model, mb)
                for k, acc in grads.items():
                    acc.add_(g[k].float() / accum_steps)
                ce = ce + ce_i / accum_steps
                aux = aux + aux_i / accum_steps
        gnorm = global_norm(grads)
        model, opt_state = adamw_update(
            grads, opt_state, model, lr_fn,
            grad_scale=clip_scale(gnorm, grad_clip))
        metrics = {"loss": ce, "aux_loss": aux, "grad_norm": gnorm,
                   "lr": lr_fn(opt_state.step)}
        return model, opt_state, metrics

    return train_step


def make_eval_step(cfg):
    """-> eval_step(model, batch) -> the mean cross-entropy (f32), without
    autograd."""
    @torch.no_grad()
    def eval_step(model, batch):
        batch = _on_device(batch, model.device)
        hidden, _ = lm.forward(cfg, model, batch)
        return chunked_cross_entropy(hidden, model.lm_head.weight.T,
                                     batch["labels"], cfg.vocab)
    return eval_step
