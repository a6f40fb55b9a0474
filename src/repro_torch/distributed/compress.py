"""Gradient compression for the DP all-reduce: block-wise int8 with error
feedback (port of `repro.distributed.compress`).

int8 plus a per-block scale cuts all-reduce bytes 4x (bf16) / 8x (f32);
error feedback keeps convergence (the quantization residual is carried
into the next step, so the *sum* of applied updates is unbiased —
Karimireddy et al. 2019). Rounding is half to even, as `jnp.round`'s, so
the output is bitwise the reference's on f32 input.

Usage: wrap grads between the backward and the optimizer:
    grads, residual = ef_compress_grads(grads, residual)
The training path does not call it, as the reference's does not.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.train.optimizer import named

BLOCK = 256


def _pad_to_block(x: torch.Tensor):
    n = x.numel()
    flat = F.pad(x.reshape(-1).float(), (0, (-n) % BLOCK))
    return flat.reshape(-1, BLOCK), n


def quantize_int8(x: torch.Tensor):
    """x (any shape) -> (q int8 (nblk, BLOCK), scales f32 (nblk,), n)."""
    blocks, n = _pad_to_block(x)
    amax = blocks.abs().amax(dim=1)
    # a tensor divisor: a scalar one is a multiply by its reciprocal on
    # CUDA, which rounds otherwise than the reference's division
    scale = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-12)
    q = torch.round(blocks / scale[:, None]).clamp(-127, 127)
    return q.to(torch.int8), scale, n


def dequantize_int8(q, scale, n, shape):
    out = (q.float() * scale[:, None]).reshape(-1)[:n]
    return out.reshape(shape)


def compress_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """What the wire sees: quantize + dequantize."""
    q, s, n = quantize_int8(x)
    return dequantize_int8(q, s, n, x.shape)


def init_residual(params) -> dict:
    """Zero f32 residuals, one a parameter (an `nn.Module` or a dict)."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named(params).items()}


def ef_compress_grads(grads: dict, residual: dict):
    """Error-feedback compression over {name: gradient}.

    Returns (compressed grads to feed the optimizer, new residual).
    Invariant: sum_t applied_t == sum_t grad_t - residual_T.
    """
    applied, new_res = {}, {}
    for k, g in grads.items():
        corrected = g.float() + residual[k]
        applied[k] = compress_roundtrip(corrected)
        new_res[k] = corrected - applied[k]
    return applied, new_res


def compression_ratio(params, from_dtype=torch.bfloat16) -> float:
    """Wire-byte ratio vs uncompressed all-reduce (scales included)."""
    sizes = [p.numel() for p in named(params).values()]
    total_in = sum(n * from_dtype.itemsize for n in sizes)
    total_out = sum(n * 1 + (n // BLOCK + 1) * 4 for n in sizes)
    return total_out / total_in
