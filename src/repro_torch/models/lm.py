"""Model assembly for the dense and moe families: parameters, forward,
full logits, prefill, decode caches and the one-token decode step (port
of `repro.models.lm`). A moe block holds `moe` (`models/moe.py`) where a
dense block holds `mlp`; everything else is shared.

The reference stacks layer weights on a leading L axis and drives them
with `lax.scan`; here the layers are an `nn.ModuleList` looped in
Python, and each cache keeps the reference's stacked (L, B, ...) layout
so that caches convert between the packages leaf for leaf.

Every entry point runs where the model's parameters lie: `init_params`
puts them on the CUDA card and raises without one unless asked for
`device="cpu"`.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as ATT
from repro_torch.models.config import check_supported
from repro_torch.models.layers import MLP, Norm, apply_norm
from repro_torch.models.moe import MoE, moe_ffn


class Block(nn.Module):
    def __init__(self, cfg, device, dtype):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, device, dtype)
        self.attn = ATT.Attention(cfg, device, dtype)
        self.ln2 = Norm(cfg.d_model, device, dtype)
        if cfg.family == "moe":
            self.moe = MoE(cfg, device, dtype)
        else:
            self.mlp = MLP(cfg, device, dtype)


class LM(nn.Module):
    """Parameters of a decoder: `embed` (Vp, d), `layers`, `final_norm`,
    `lm_head` (an `nn.Linear`, weight (Vp, d)). Every parameter is in
    the model dtype but a moe block's router, which is f32."""

    def __init__(self, cfg, device):
        super().__init__()
        check_supported(cfg)
        dtype = getattr(torch, cfg.dtype)
        vp, d = cfg.padded_vocab, cfg.d_model
        self.embed = nn.Parameter(torch.empty(vp, d, device=device,
                                              dtype=dtype))
        self.layers = nn.ModuleList(Block(cfg, device, dtype)
                                    for _ in range(cfg.n_layers))
        self.final_norm = Norm(d, device, dtype)
        self.lm_head = nn.Linear(d, vp, bias=False, device=device,
                                 dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg, generator: torch.Generator | int, device=None) -> LM:
    """Random weights with the reference's scales (normal; embeddings
    x0.02, projections x d_in^-0.5; norms 1, biases 0), drawn from an
    explicit generator (a seed makes one on the device). The numbers are
    not the reference's: its `jax.random` draws differ. d_in is an
    `nn.Linear` weight's last dimension; a moe tensor is stored for
    `x @ W`, (.., d_in, d_out), so its d_in is the one before."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device).manual_seed(generator)
    with torch.no_grad():
        model = LM(cfg, device)
        for name, t in model.named_parameters():
            if name.endswith(".w") or name.endswith(".bias"):
                t.fill_(1.0 if name.endswith(".w") else 0.0)
                continue
            t.normal_(generator=generator)
            d_in = t.shape[-2] if ".moe." in name else t.shape[-1]
            t.mul_(0.02 if name == "embed" else d_in ** -0.5)
    return model.requires_grad_(False)


def _embed(cfg, model: LM, tokens: torch.Tensor) -> torch.Tensor:
    x = model.embed[tokens]
    if cfg.embed_scale:
        # the scale rounds to the activation dtype first, as in jnp
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _positions(batch: dict, b: int, s: int, device) -> torch.Tensor:
    pos = batch.get("positions")
    if pos is None:
        return torch.arange(s, device=device)[None, :].expand(b, s)
    return torch.as_tensor(pos, device=device)


def _ffn_residual(cfg, lp: Block, x):
    """-> (x + the block's FFN of x, its auxiliary loss: the router's
    load-balancing loss for a moe block, None for a dense one)."""
    h = apply_norm(cfg, lp.ln2, x)
    if cfg.family == "moe":
        y, aux = moe_ffn(cfg, lp.moe, h)
        return x + y, aux
    return x + lp.mlp(h), None


def _block_fwd(cfg, lp: Block, x, positions):
    """-> (x after the block, its auxiliary loss or None, the k and v its
    attention cached)."""
    a, k, v = ATT.self_attention(cfg, lp.attn, apply_norm(cfg, lp.ln1, x),
                                 positions)
    x, aux = _ffn_residual(cfg, lp, x + a)
    return x, aux, k, v


def _stack(cfg, model: LM, batch: dict, caches: dict | None):
    """The layers over `batch["tokens"]` -> (hidden after the final norm,
    aux summed over the layers); with `caches`, each layer's k and v
    land in caches["k"][i] and caches["v"][i]."""
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    b, s = tokens.shape
    positions = _positions(batch, b, s, model.device)
    x = _embed(cfg, model, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(model.layers):
        x, a, k, v = _block_fwd(cfg, lp, x, positions)
        if a is not None:
            aux = aux + a
        if caches is not None:
            caches["k"][i], caches["v"][i] = k, v
    return apply_norm(cfg, model.final_norm, x), aux


@torch.no_grad()
def forward(cfg, model: LM, batch: dict):
    """-> (hidden (B, S, d), aux_loss f32 scalar summed over the layers)."""
    return _stack(cfg, model, batch, None)


@torch.no_grad()
def forward_collect(cfg, model: LM, batch: dict):
    """Prefill: -> (hidden (B, S, d), dense caches {"k", "v"
    (L, B, S, KV, hd), "pos" (B,)}) ready for `decode_step`."""
    b, s = torch.as_tensor(batch["tokens"]).shape
    dt = getattr(torch, cfg.dtype)
    shape = (cfg.n_layers, b, s, cfg.n_kv, cfg.hd)
    caches = {"k": torch.empty(shape, dtype=dt, device=model.device)}
    caches["v"] = torch.empty_like(caches["k"])
    hidden, _ = _stack(cfg, model, batch, caches)
    caches["pos"] = torch.full((b,), s, dtype=torch.int32,
                               device=model.device)
    return hidden, caches


def prefill_step(cfg, model: LM, batch: dict):
    """-> (last-token logits (B, vocab), dense caches)."""
    hidden, caches = forward_collect(cfg, model, batch)
    with torch.no_grad():
        logits = model.lm_head(hidden[:, -1, :])[..., :cfg.vocab]
    return logits, caches


@torch.no_grad()
def logits_full(cfg, model: LM, batch: dict) -> torch.Tensor:
    """Small-model convenience: full (B, S, vocab) logits."""
    hidden, _ = forward(cfg, model, batch)
    return model.lm_head(hidden)[..., :cfg.vocab]


def init_decode_caches(cfg, batch: int, max_len: int, kind: str = "dense",
                       device=None) -> dict:
    """Zeroed decode state, stacked over layers. kind: dense | lsm."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    if kind == "lsm":
        out = {k: torch.zeros((cfg.n_layers,) + s, dtype=d, device=device)
               for k, (s, d) in ATT.lsm_cache_shapes(cfg, batch,
                                                     max_len).items()}
    elif kind == "dense":
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
        out = {"k": torch.zeros(shape, dtype=dt, device=device),
               "v": torch.zeros(shape, dtype=dt, device=device)}
    else:
        raise ValueError(f"cache kind {kind!r}: dense | lsm")
    out["pos"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return out


@torch.no_grad()
def decode_step(cfg, model: LM, token: torch.Tensor, caches: dict,
                kind: str = "dense"):
    """token (B,) int -> (logits (B, vocab), caches). The cache tensors
    are updated in place; the returned dict holds the new counters."""
    pos = caches["pos"]
    x = _embed(cfg, model, torch.as_tensor(token, device=model.device))
    x = x[:, None, :]                                       # (B, 1, d)
    if kind == "lsm":
        x, caches = _decode_lsm_stack(cfg, model, x, caches)
    elif kind == "dense":
        x, caches = _decode_dense_stack(cfg, model, x, caches)
    else:
        raise ValueError(f"cache kind {kind!r}: dense | lsm")
    x = apply_norm(cfg, model.final_norm, x)
    logits = model.lm_head(x[:, 0, :])[..., :cfg.vocab]
    return logits, dict(caches, pos=pos + 1)


def _decode_dense_stack(cfg, model: LM, x, caches):
    pos = caches["pos"]
    at = int(pos[0])                 # the uniform write position (host)
    for i, lp in enumerate(model.layers):
        x = x + ATT.decode_self_attention(
            cfg, lp.attn, apply_norm(cfg, lp.ln1, x), caches["k"][i],
            caches["v"][i], pos, at)
        x, _ = _ffn_residual(cfg, lp, x)
    return x, caches


def _decode_lsm_stack(cfg, model: LM, x, caches):
    pos = caches["pos"]
    slots = caches["hot_len"][:, 0].tolist()   # each layer's write slot
    hot_len = []
    for i, lp in enumerate(model.layers):
        lcache = {k: caches[k][i] for k in ATT.LSM_KEYS}
        a, lcache = ATT.lsm_decode_self_attention(
            cfg, lp.attn, apply_norm(cfg, lp.ln1, x), lcache, pos, slots[i])
        hot_len.append(lcache["hot_len"])
        x, _ = _ffn_residual(cfg, lp, x + a)
    return x, dict(caches, hot_len=torch.stack(hot_len))
