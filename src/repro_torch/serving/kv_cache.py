"""sLSM-tiered KV cache management (the paper's write path, for tokens):
the port of `repro.serving.kv_cache`.

Lifecycle per attention (a layer; for the hybrid family, an application
of its shared block):
  * decode appends K/V to the *hot window* (the memory buffer);
  * when the hot window fills, `seal_hot_block` moves its oldest `mu`
    tokens into an immutable cold block plus a summary vector (run seal
    and index build: the summary is the Bloom-filter/fence analogue);
  * attention reads the hot window and the top-k summary-gated cold
    blocks only.

The host decides *when* to seal, as in the reference. The seal updates
the cache tensors in place and raises where the reference would clamp
an out-of-range block slot.
"""
from __future__ import annotations

import time

import torch

from repro_torch.models import lm


def _no_kv_cache(cfg) -> ValueError:
    if cfg.family == "encdec":
        return ValueError(f"{cfg.name}: the decoder is bounded at "
                          f"{lm.DEC_POSITIONS} positions, so its KV cache "
                          "is never tiered; use kind='dense'")
    return ValueError(f"{cfg.name}: an attention-free ({cfg.family}) model "
                      "has no KV cache to tier; use kind='dense'")


def _kv_stack(cfg, caches: dict) -> dict:
    """The stacked K/V a family tiers (`lm.kv_stack`): the layers' for
    dense, moe and vlm, the shared block's applications for hybrid. An
    ssm model has none, an encdec model's is never tiered: ValueError."""
    stack = lm.kv_stack(cfg, caches)
    if stack is None or cfg.family == "encdec":
        raise _no_kv_cache(cfg)
    return stack


def _carry_state(cfg, dense_caches: dict, max_len: int, kind: str) -> dict:
    """Zeroed decode caches of `kind` for the prefill's batch, with the
    prefill's `pos` and, for the ssm and hybrid families, copies of its
    per-layer decode state (decode updates it in place, so each layout
    made from one prefill gets its own); the encdec family's encoder
    K/V carried as they are (decode only reads them)."""
    pos = dense_caches["pos"]
    enc = dense_caches.get("enc_k")
    out = lm.init_decode_caches(cfg, pos.shape[0], max_len, kind,
                                device=pos.device,
                                enc_len=None if enc is None else enc.shape[2])
    for key in ("ssm", "conv", "pos"):
        if key in out:
            out[key] = dense_caches[key].clone()
    for key in ("enc_k", "enc_v"):
        if key in out:
            out[key] = dense_caches[key]
    return out


def seal_hot_block(cfg, caches: dict) -> dict:
    """Seal the oldest mu hot tokens of every (stack slot, batch row)
    into its cold block slot n_blocks. The stack is the family's tiered
    K/V (`_kv_stack`): leaves (N, B, ...), hot_len and n_blocks (N, B)."""
    mu = cfg.lsm_block
    stack = _kv_stack(cfg, caches)
    hot_k, hot_v = stack["hot_k"], stack["hot_v"]
    blk_k, blk_v, summ = stack["blk_k"], stack["blk_v"], stack["summ"]
    n_blocks = stack["n_blocks"]
    if int(n_blocks.max()) >= blk_k.shape[2]:
        raise IndexError(f"no free cold block slot ({blk_k.shape[2]} "
                         "blocks): size the cache for a longer max_len")
    n_l, b = n_blocks.shape
    li = torch.arange(n_l, device=n_blocks.device)[:, None]
    bi = torch.arange(b, device=n_blocks.device)[None, :]
    slot = n_blocks.long()
    new_k, new_v = hot_k[:, :, :mu], hot_v[:, :, :mu]      # (N, B, mu, ..)
    blk_k[li, bi, slot] = new_k
    blk_v[li, bi, slot] = new_v
    summ[li, bi, slot] = new_k.float().mean(dim=2).to(summ.dtype)
    w = hot_k.shape[2]
    for hot in (hot_k, hot_v):
        hot[:, :, :w - mu] = hot[:, :, mu:].clone()
        hot[:, :, w - mu:] = 0
    return lm.with_kv_stack(cfg, caches, dict(
        stack, hot_len=stack["hot_len"] - mu, n_blocks=n_blocks + 1))


def lsm_from_dense(cfg, dense_caches: dict, max_len: int) -> dict:
    """Prefill (dense) caches -> the tiered layout: full mu-token
    prefixes of the stacked K/V (`_kv_stack`) become cold blocks; the
    rest lands in the hot window. The ssm and hybrid families' decode
    state is carried over (copied)."""
    mu, w = cfg.lsm_block, cfg.lsm_hot_window
    dense = _kv_stack(cfg, dense_caches)
    k, v = dense["k"], dense["v"]                           # (N, B, S, ..)
    n_l, b, s, kv, hd = k.shape
    n_cold = max(0, s - 1) // mu                            # keep >=1 hot
    hot_start = n_cold * mu
    hot_used = s - hot_start
    if hot_used > w:
        raise ValueError(f"{hot_used} prompt tokens left for a hot window "
                         f"of {w}")
    caches = _carry_state(cfg, dense_caches, max_len, "lsm")
    out = lm.kv_stack(cfg, caches)
    if n_cold > out["blk_k"].shape[2]:
        raise ValueError(f"{n_cold} cold blocks for {out['blk_k'].shape[2]}"
                         " slots: raise max_len")
    if n_cold:
        cold_k = k[:, :, :hot_start].reshape(n_l, b, n_cold, mu, kv, hd)
        cold_v = v[:, :, :hot_start].reshape(n_l, b, n_cold, mu, kv, hd)
        out["blk_k"][:, :, :n_cold] = cold_k
        out["blk_v"][:, :, :n_cold] = cold_v
        out["summ"][:, :, :n_cold] = cold_k.float().mean(dim=3).to(
            out["summ"].dtype)
    out["hot_k"][:, :, :hot_used] = k[:, :, hot_start:s]
    out["hot_v"][:, :, :hot_used] = v[:, :, hot_start:s]
    out["hot_len"].fill_(hot_used)
    out["n_blocks"].fill_(n_cold)
    return caches


def grow_dense(cfg, caches: dict, max_len: int) -> dict:
    """Prefill (dense) caches grown to max_len positions for decode: the
    stacked K/V (the shared block's too, which the reference's `generate`
    leaves at the prompt's length) padded with zeros; the ssm and hybrid
    families' decode state carried over (copied)."""
    grown = _carry_state(cfg, caches, max_len, "dense")
    stack = lm.kv_stack(cfg, caches)
    if stack is not None:
        s = stack["k"].shape[2]
        for key in ("k", "v"):
            lm.kv_stack(cfg, grown)[key][:, :, :s] = stack[key]
    return grown


def _now(device, stats) -> float | None:
    """The host clock after the device has caught up; read only when the
    caller asked for `stats`, so an unmeasured run adds no sync."""
    if stats is None:
        return None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@torch.no_grad()
def generate(cfg, model, prompt_batch: dict, steps: int,
             kind: str = "dense", max_len: int | None = None,
             stats: dict | None = None):
    """Greedy generation: prefill, then one `decode_step` a token, with a
    host-decided seal whenever the hot window is full (kind "lsm").
    Runs where `model` lies. -> (tokens (B, steps), caches). An ssm
    model has no KV cache to tier, an encdec model's decoder is bounded
    at 448 positions: kind "lsm" raises ValueError for both (the
    reference raises KeyError for both).

    If `stats` is a dict, it receives `prefill_s` (prefill and cache
    layout) and `decode_s` (the decode loop), each closed by a device
    synchronize, `seals`, and `finite`: whether every logit was finite."""
    b, s = torch.as_tensor(prompt_batch["tokens"]).shape
    max_len = max_len or (s + steps + 8)
    if kind == "lsm" and cfg.family in ("ssm", "encdec"):
        raise _no_kv_cache(cfg)
    t0 = _now(model.device, stats)
    logits, caches = lm.prefill_step(cfg, model, prompt_batch)
    if kind == "lsm":
        caches = lsm_from_dense(cfg, caches, max_len)
    else:
        caches = grow_dense(cfg, caches, max_len)
    t1 = _now(model.device, stats)
    out_tokens = [logits.argmax(-1)]
    finite = torch.isfinite(logits).all()
    seals = 0
    for _ in range(steps - 1):
        logits, caches = lm.decode_step(cfg, model, out_tokens[-1], caches,
                                        kind)
        out_tokens.append(logits.argmax(-1))
        if stats is not None:
            finite &= torch.isfinite(logits).all()
        # host-orchestrated seal, like the engine's merges
        if kind == "lsm" and int(_kv_stack(cfg, caches)["hot_len"][0, 0]) \
                >= cfg.lsm_hot_window:
            caches = seal_hot_block(cfg, caches)
            seals += 1
    if stats is not None:
        stats.update(prefill_s=t1 - t0,
                     decode_s=_now(model.device, stats) - t1,
                     seals=seals, finite=bool(finite))
    return torch.stack(out_tokens, dim=1), caches
