"""GQA attention: chunked-flash prefill, cached decode over a dense cache,
decode over the sLSM-tiered cache, and Whisper's cross-attention (port
of `repro.models.attention`, single-device paths).

Every decode path ends in one call of the `lsm_attention` kernel
(`kernels/lsm_attention`), which the reference left to plain jnp on this
path: the dense one through `decode_attention_op` (validity from the
lengths), the tiered one through `lsm_decode_attention`, which reads the
hot window and the selected cold blocks in place, and a decode step's
cross-attention through `decode_attention_op` over all T encoder
positions. Prefill attention is no kernel in the reference either; here
it is a plain chunked mirror of its `flash_attention`.

Decode writes the new token's K/V into the cache in place (the
reference returns updated copies) at a position the caller read to the
host; an out-of-range position raises instead of being clamped.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels.lsm_attention import ops as KLA
from repro_torch.models.layers import apply_mrope, apply_rope

NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, cfg, device, dtype):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
        bias = cfg.qkv_bias
        self.wq = nn.Linear(d, h * hd, bias=bias, device=device, dtype=dtype)
        self.wk = nn.Linear(d, kv * hd, bias=bias, device=device, dtype=dtype)
        self.wv = nn.Linear(d, kv * hd, bias=bias, device=device, dtype=dtype)
        self.wo = nn.Linear(h * hd, d, bias=False, device=device, dtype=dtype)


def _project_q(cfg, p: Attention, x):
    b, s, _ = x.shape
    return p.wq(x).reshape(b, s, cfg.n_heads, cfg.hd)


def _project_kv(cfg, p: Attention, x):
    b, s, _ = x.shape
    return (p.wk(x).reshape(b, s, cfg.n_kv, cfg.hd),
            p.wv(x).reshape(b, s, cfg.n_kv, cfg.hd))


def _expand_kv(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating each kv head over its
    query group."""
    return x.repeat_interleave(h // x.shape[2], dim=2)


# --------------------------------------------------------------------------
# prefill: chunked flash attention (plain torch)
# --------------------------------------------------------------------------

def _fit(s: int, c: int) -> int:
    """Largest divisor of s that is <= c (the reference's chunk rule)."""
    c = min(c, s)
    while s % c:
        c -= 1
    return c


def flash_attention(q, k, v, *, causal: bool, q_chunk: int = 1024,
                    k_chunk: int = 1024, q_offset: int = 0):
    """Online softmax over KV chunks in f32, as the reference's.

    q (B, Sq, H, hd); k, v (B, Sk, H, hd), already group-expanded. Causal
    KV chunks wholly after a query chunk are skipped: the reference adds
    exactly zero for them (p = exp(-1e30 - m) = 0, correction 1).
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = hd ** -0.5
    q_chunk, k_chunk = _fit(sq, q_chunk), _fit(sk, k_chunk)
    qf = q.float().transpose(1, 2)                         # (B, H, Sq, hd)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    out = torch.empty_like(qf)
    for q0 in range(0, sq, q_chunk):
        qb = qf[:, :, q0:q0 + q_chunk]
        q_pos = q_offset + q0 + torch.arange(q_chunk, device=q.device)
        m = torch.full((b, h, q_chunk), NEG_INF, device=q.device)
        den = torch.zeros((b, h, q_chunk), device=q.device)
        acc = torch.zeros((b, h, q_chunk, hd), device=q.device)
        for k0 in range(0, sk, k_chunk):
            if causal and k0 > q_offset + q0 + q_chunk - 1:
                break
            s = qb @ kf[:, :, k0:k0 + k_chunk].transpose(-1, -2) * scale
            if causal:
                k_pos = k0 + torch.arange(k_chunk, device=q.device)
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p_att = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            den = den * corr + p_att.sum(-1)
            acc = acc * corr[..., None] + p_att @ vf[:, :, k0:k0 + k_chunk]
            m = m_new
        out[:, :, q0:q0 + q_chunk] = acc / den.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def self_attention(cfg, p: Attention, x, positions, *, causal: bool = True,
                   positions3=None):
    """Full-sequence self-attention (prefill) -> (out (B, S, d), the
    rotated k and the v (B, S, KV, hd) it attended: what prefill caches,
    which the reference recomputes from the same inputs). M-RoPE where
    the config has it and `positions3` (3, B, S) is given, else RoPE
    where `positions` is given, else no rotation (Whisper)."""
    q = _project_q(cfg, p, x)
    k, v = _project_kv(cfg, p, x)
    if cfg.mrope and positions3 is not None:
        q = apply_mrope(q, positions3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions3, cfg.rope_theta, cfg.mrope_sections)
    elif positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention(q, _expand_kv(k, cfg.n_heads),
                          _expand_kv(v, cfg.n_heads), causal=causal)
    b, s = out.shape[:2]
    return p.wo(out.reshape(b, s, -1)), k, v


def project_enc_kv(cfg, p: Attention, enc_h):
    """The encoder's K/V (B, T, KV, hd) for a decoder layer's
    cross-attention, computed once and cached."""
    return _project_kv(cfg, p, enc_h)


def cross_attention(cfg, p: Attention, x, enc_k, enc_v):
    """Decoder cross-attention over the cached encoder K/V (B, T, KV, hd),
    no rotation, the reference's chunks (all of Sq and T up to 1024)."""
    q = _project_q(cfg, p, x)
    out = flash_attention(q, _expand_kv(enc_k, cfg.n_heads),
                          _expand_kv(enc_v, cfg.n_heads), causal=False,
                          q_chunk=min(1024, q.shape[1]),
                          k_chunk=min(1024, enc_k.shape[1]))
    b, s = out.shape[:2]
    return p.wo(out.reshape(b, s, -1))


def decode_cross_attention(cfg, p: Attention, x1, enc_k, enc_v):
    """One decode token's cross-attention: the reference's
    `cross_attention` at Sq = 1, here one kernel call over all T encoder
    positions (lengths T in every row). x1 (B, 1, d); enc_k/v
    (B, T, KV, hd), a layer's view of the stacked cache."""
    b, t = enc_k.shape[:2]
    q = _project_q(cfg, p, x1)[:, 0].to(enc_k.dtype).contiguous()
    lengths = torch.full((b,), t, dtype=torch.int32, device=q.device)
    out = KLA.decode_attention_op(q, enc_k, enc_v, lengths, cfg.hd ** -0.5)
    return p.wo(out.reshape(b, 1, cfg.n_heads * cfg.hd).to(x1.dtype))


# --------------------------------------------------------------------------
# decode: dense ragged cache
# --------------------------------------------------------------------------

def decode_self_attention(cfg, p: Attention, x1, cache_k, cache_v, pos,
                          at: int):
    """One-token decode with a dense KV cache.

    x1 (B, 1, d); cache_k/v (B, Smax, KV, hd), written in place at the
    uniform position `at` (= pos[0], read by the caller); pos (B,)
    current lengths. Position l of row b is attended when l <= pos[b].
    Returns out (B, 1, d).
    """
    b = x1.shape[0]
    if not 0 <= at < cache_k.shape[1]:
        raise IndexError(f"decode position {at} outside the dense cache of "
                         f"{cache_k.shape[1]}")
    q = _project_q(cfg, p, x1)                             # (B, 1, H, hd)
    k1, v1 = _project_kv(cfg, p, x1)
    if cfg.mrope:               # text decode: three equal streams
        pos3 = pos[None, :, None].expand(3, b, 1)
        q = apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k1 = apply_mrope(k1, pos3, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k1 = apply_rope(k1, pos[:, None], cfg.rope_theta)
    cache_k[:, at] = k1[:, 0].to(cache_k.dtype)
    cache_v[:, at] = v1[:, 0].to(cache_v.dtype)
    qg = q[:, 0].to(cache_k.dtype).contiguous()            # (B, H, hd)
    out = KLA.decode_attention_op(qg, cache_k, cache_v, pos + 1,
                                  cfg.hd ** -0.5)
    return p.wo(out.reshape(b, 1, cfg.n_heads * cfg.hd).to(x1.dtype))


# --------------------------------------------------------------------------
# decode: sLSM-tiered cache (hot window + summary-gated cold blocks)
# --------------------------------------------------------------------------

LSM_KEYS = ("hot_k", "hot_v", "blk_k", "blk_v", "summ", "hot_len",
            "n_blocks")


def lsm_cache_shapes(cfg, batch: int, max_len: int) -> dict:
    """Shape spec for one layer's tiered cache: name -> (shape, dtype).
    The block axis is padded to a multiple of 32, as in the reference,
    so caches convert between the packages shape for shape."""
    w, mu = cfg.lsm_hot_window, cfg.lsm_block
    nb = max(1, math.ceil(max(0, max_len - w) / mu) + 1)
    nb = ((nb + 31) // 32) * 32
    kv, hd = cfg.n_kv, cfg.hd
    dt = getattr(torch, cfg.dtype)
    return dict(
        hot_k=((batch, w, kv, hd), dt), hot_v=((batch, w, kv, hd), dt),
        blk_k=((batch, nb, mu, kv, hd), dt),
        blk_v=((batch, nb, mu, kv, hd), dt),
        summ=((batch, nb, kv, hd), dt),
        hot_len=((batch,), torch.int32), n_blocks=((batch,), torch.int32),
    )


def lsm_decode_self_attention(cfg, p: Attention, x1, cache: dict, pos,
                              at: int):
    """One-token decode against one layer's tiered cache.

    The hot window is the sLSM memory buffer (always searched); cold
    blocks are immutable mu-token runs whose summary vector gates access
    (the Bloom/fence analogue): only the top-k scoring blocks are read.
    Plain RoPE for every family, M-RoPE's included, as in the reference
    (for text its three streams are equal). The new K/V lands in hot
    slot `at` (= hot_len[0], read by the caller) in place. Returns
    (out (B, 1, d), cache with hot_len + 1).

    This is the reference's single-device branch, with its grouped
    selection (`lsm_dp_groups` G > 1 where G divides the block count
    and topk <= NB / G: a top-k a group, then a global threshold over
    the G * topk candidates, all of which go to the kernel, masked by
    `ok`). Its sharded-stats branch needs a device mesh, which the port
    has not.
    """
    b = x1.shape[0]
    hot_k, hot_v = cache["hot_k"], cache["hot_v"]
    if not 0 <= at < hot_k.shape[1]:
        raise IndexError(f"hot slot {at} outside the hot window of "
                         f"{hot_k.shape[1]}: seal first")
    hd = cfg.hd
    nb = cache["blk_k"].shape[1]
    topk = min(cfg.lsm_topk, nb)
    gsel = max(1, min(cfg.lsm_dp_groups, nb))
    if not (nb % gsel == 0 and topk <= nb // gsel):
        gsel = 1
    q = _project_q(cfg, p, x1)
    k1, v1 = _project_kv(cfg, p, x1)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k1 = apply_rope(k1, pos[:, None], cfg.rope_theta)
    hot_k[:, at] = k1[:, 0].to(hot_k.dtype)
    hot_v[:, at] = v1[:, 0].to(hot_v.dtype)
    hot_len = cache["hot_len"] + 1

    # block selection (the filter probe): q in the cache dtype, f32 scores
    qg = q[:, 0].to(cache["blk_k"].dtype)                   # (B, H, hd)
    ids, ok = KLA.select_blocks(qg, cache["summ"], cache["n_blocks"], topk,
                                gsel)
    out = KLA.lsm_decode_attention(qg, hot_k, hot_v, hot_len,
                                   cache["blk_k"], cache["blk_v"], ids, ok,
                                   hd ** -0.5)
    out = out.reshape(b, 1, cfg.n_heads * hd).to(x1.dtype)
    return p.wo(out), dict(cache, hot_len=hot_len)
