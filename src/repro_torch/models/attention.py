"""GQA attention: chunked-flash prefill, cached decode over a dense cache,
decode over the sLSM-tiered cache, and Whisper's cross-attention (port
of `repro.models.attention`).

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

from repro_torch.distributed import runtime as RT
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


def _split_heads(t, n: int, hd: int):
    """(B, S, n * hd) -> (B, S, n, hd). On a mesh the projection's output
    columns are model-sharded; where n heads do not divide |model| the
    split has no DTensor rule, so the columns are gathered first (the
    activation, never the weight)."""
    b, s, _ = t.shape
    if RT.is_dtensor(t) and n % RT.model_size():
        t = RT.constrain(t, "dp" if b % RT.dp_size() == 0 else None, None,
                         None)
    return t.reshape(b, s, n, hd)


def _project_q(cfg, p: Attention, x):
    return _split_heads(p.wq(x), cfg.n_heads, cfg.hd)


def _project_kv(cfg, p: Attention, x):
    return (_split_heads(p.wk(x), cfg.n_kv, cfg.hd),
            _split_heads(p.wv(x), cfg.n_kv, cfg.hd))


def _expand_kv(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating each kv head over its
    query group."""
    y = x.repeat_interleave(h // x.shape[2], dim=2)
    # on a mesh, kv heads that do not divide |model| are replicated; the
    # expansion's gradient (a sum over each group by a view) has no
    # DTensor rule on head-sharded gradients, so the layout is pinned
    if RT.is_dtensor(y) and x.shape[2] % RT.model_size():
        b = y.shape[0]
        y = RT.constrain(y, "dp" if b % RT.dp_size() == 0 else None, None,
                         None, None)
    return y


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

    On DTensors (a mesh) each rank attends its own batch rows and heads,
    on `to_local()` shards: the layout keeps q's batch (dim 0) and head
    (dim 2) sharding and gathers any other, k and v take the same, and
    the output is q's layout. (DTensor has no rule for the batched
    products' flattening of a head-sharded (B, H) on every torch
    release.)
    """
    if not RT.is_dtensor(q):
        return _flash(q, k, v, causal, q_chunk, k_chunk, q_offset)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    place = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
                  for p in q.placements)
    q, k, v = (t.redistribute(mesh, place).to_local() for t in (q, k, v))
    out = _flash(q, k, v, causal, q_chunk, k_chunk, q_offset)
    return DTensor.from_local(out, mesh, place, run_check=False)


def _flash(q, k, v, causal: bool, q_chunk: int, k_chunk: int,
           q_offset: int):
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

def _write_slot(cache, at: int, row) -> None:
    """cache[:, at] = row (B, KV, hd), in place. On a DTensor cache whose
    position axis is sharded, each rank writes the shard that holds
    position `at`, if it holds it: DTensor's own `cache[:, at]` would
    gather that axis and write into the gathered copy."""
    if not RT.is_dtensor(cache):
        cache[:, at] = row.to(cache.dtype)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = cache.device_mesh
    if not RT.is_dtensor(row):
        row = DTensor.from_local(row, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    # the row laid out as the cache without its position axis
    place = [Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard)
             and p.dim != 1 else Replicate() for p in cache.placements]
    local_row = row.redistribute(mesh, place).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    if offset[1] <= at < offset[1] + shape[1]:
        cache.to_local()[:, at - offset[1]] = local_row.to(cache.dtype)


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
    _write_slot(cache_k, at, k1[:, 0])
    _write_slot(cache_v, at, v1[:, 0])
    qg = q[:, 0].to(cache_k.dtype).contiguous()            # (B, H, hd)
    # the kv-head axis (H = KV x group, kv-major) carries the model
    # sharding where it divides, as the reference pins it
    qg = RT.constrain(qg, "dp" if b % RT.dp_size() == 0 else None,
                      "model" if cfg.n_kv % RT.model_size() == 0 else None,
                      None)
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

    Two branches, taken where the reference takes them. With a mesh
    registered, b == 1, the blocks divisible by |data|, the kv heads by
    |model| and `lsm_dp_groups` 1: the sharded-stats branch
    (`_lsm_stats`). Otherwise the single-device branch, one kernel call,
    with the grouped selection (`lsm_dp_groups` G > 1 where G divides
    the block count and topk <= NB / G: a top-k a group, then a global
    threshold over the G * topk candidates, all of which go to the
    kernel, masked by `ok`).
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
    _write_slot(hot_k, at, k1[:, 0])
    _write_slot(hot_v, at, v1[:, 0])
    hot_len = cache["hot_len"] + 1

    # block selection (the filter probe): q in the cache dtype, f32 scores;
    # on a mesh, heads sharded only where the kv heads divide |model|
    qg = q[:, 0].to(cache["blk_k"].dtype)                   # (B, H, hd)
    qg = RT.constrain(qg, "dp" if b % RT.dp_size() == 0 else None,
                      "model" if cfg.n_kv % RT.model_size() == 0 else None,
                      None)
    if (RT.mesh() is not None and b == 1 and nb % RT.data_size() == 0
            and cfg.n_kv % RT.model_size() == 0 and cfg.lsm_dp_groups == 1):
        out = _lsm_stats(cfg, qg, dict(cache, hot_len=hot_len), topk)
        out = out.reshape(b, 1, cfg.n_heads * hd).to(x1.dtype)
        return p.wo(out), dict(cache, hot_len=hot_len)
    ids, ok = KLA.select_blocks(qg, cache["summ"], cache["n_blocks"], topk,
                                gsel)
    out = KLA.lsm_decode_attention(qg, hot_k, hot_v, hot_len,
                                   cache["blk_k"], cache["blk_v"], ids, ok,
                                   hd ** -0.5)
    out = out.reshape(b, 1, cfg.n_heads * hd).to(x1.dtype)
    return p.wo(out), dict(cache, hot_len=hot_len)


def _lsm_cold_stats(cfg, qg, blk_k, blk_v, ids, ok, scale: float):
    """Cold-block attention stats, computed where the blocks live (the
    reference's `_lsm_cold_stats_shardmap` body, per rank).

    qg (B, H, hd); blk_k/v (B, NB, mu, KV, hd), the same full cache on
    every rank; ids, ok (B, KV, topk) global block ids. This rank (data
    rank r, model rank m) reads its blocks r*NBl .. (r+1)*NBl - 1 for
    its kv heads m*KVl .. (m+1)*KVl - 1; its online-softmax stats merge
    over the data axis with one all-reduce(MAX) and two all-reduce(SUM)
    (O(KV*g*hd) bytes, not block payloads), then gather over the model
    axis. A rank holding none of the selected blocks has m = NEG_INF
    (-1e30, not -inf) and exp(m - m_global) = 0 weights it out. The
    probabilities stay f32 in the products with V, as in the kernel (the
    reference rounds them to the cache dtype for its bf16 products; in
    f32 the two are one). Returns (m, l (B, KV, g), acc (B, KV, g, hd))
    in f32.

    DTensor blocks (laid out by `cache_pspecs`: the block axis over data,
    the kv heads over model) are read as this rank's own shards, which
    are those same blocks and heads; qg, ids and ok are then gathered
    whole.
    """
    b, nb, mu, kv, hd = blk_k.shape
    group = cfg.n_heads // kv
    topk = ids.shape[-1]
    nbl, kvl = nb // RT.data_size(), kv // RT.model_size()
    r, m = RT.axis_rank("data"), RT.axis_rank("model")
    heads = slice(m * kvl, (m + 1) * kvl)
    if RT.is_dtensor(blk_k):
        bk, bv = (_own_blocks(t) for t in (blk_k, blk_v))
        qg, ids, ok = (_whole(t) for t in (qg, ids, ok))
    else:
        # (B, NBl, mu, KVl, hd)
        bk = blk_k[:, r * nbl:(r + 1) * nbl, :, heads]
        bv = blk_v[:, r * nbl:(r + 1) * nbl, :, heads]
    loc = ids[:, heads] - r * nbl
    mine = (loc >= 0) & (loc < nbl) & ok[:, heads]          # (B, KVl, topk)
    locc = loc.clamp(0, nbl - 1)
    # block locc[b, k, t]'s rows of kv head k: (B, KVl, topk, mu, hd)
    bi = torch.arange(b, device=ids.device)[:, None, None]
    ki = torch.arange(kvl, device=ids.device)[None, :, None]
    sel_k = bk.permute(0, 1, 3, 2, 4)[bi, locc, ki]
    sel_v = bv.permute(0, 1, 3, 2, 4)[bi, locc, ki]
    q_l = qg.reshape(b, kv, group, hd)[:, heads].float()
    s = torch.einsum("bkgd,bktmd->bkgtm", q_l, sel_k.float()) * scale
    s = torch.where(mine[:, :, None, :, None], s, NEG_INF)
    s = s.reshape(b, kvl, group, topk * mu)
    m_p = s.amax(-1)                                         # (B, KVl, g)
    p_att = torch.exp(s - m_p[..., None])
    p_att = torch.where(torch.isfinite(s), p_att, 0.0)
    l_p = p_att.sum(-1)
    acc_p = torch.einsum("bkgs,bksd->bkgd", p_att,
                         sel_v.reshape(b, kvl, topk * mu, hd).float())
    # merge across data shards: stats only
    m_g = RT.all_reduce_(m_p.clone(), "data", op=RT.MAX)
    corr = torch.exp(m_p - m_g)
    l_g = RT.all_reduce_(l_p * corr, "data")
    acc_g = RT.all_reduce_(acc_p * corr[..., None], "data")
    return (RT.all_gather(m_g, "model", 1), RT.all_gather(l_g, "model", 1),
            RT.all_gather(acc_g, "model", 1))


def _own_blocks(t):
    """This rank's shard of a DTensor block store (B, NB, mu, KV, hd):
    its blocks over the data axis, its kv heads over the model axis."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    place = [Shard(1) if n == "data" else Shard(3) if n == "model"
             else Replicate() for n in mesh.mesh_dim_names]
    return t.redistribute(mesh, place).to_local()


def _whole(t):
    """A DTensor gathered whole on every rank (a plain tensor as it is)."""
    if not RT.is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh,
                          [Replicate()] * t.device_mesh.ndim).to_local()


def _lsm_stats(cfg, qg, cache: dict, topk: int):
    """The sharded-stats branch of tiered decode (the reference's
    `use_stats`): the global top-k blocks, their stats from
    `_lsm_cold_stats`, then the hot window's stats (below the new
    hot_len) merged with them by online softmax. qg (B, H, hd) in the
    cache dtype; the new K/V already in the hot window. -> (B, H, hd)
    f32."""
    b, h, hd = qg.shape
    kv = cfg.n_kv
    ids, ok = KLA.select_blocks(qg, cache["summ"], cache["n_blocks"], topk)
    m_c, l_c, acc_c = _lsm_cold_stats(cfg, qg, cache["blk_k"],
                                      cache["blk_v"], ids, ok, hd ** -0.5)
    hot_k, hot_v = cache["hot_k"], cache["hot_v"]
    w = hot_k.shape[1]
    q4 = qg.reshape(b, kv, h // kv, hd).float()
    sf = torch.einsum("bkgd,bskd->bkgs", q4, hot_k.float()) * hd ** -0.5
    hot_mask = torch.arange(w, device=qg.device)[None, :] \
        < cache["hot_len"][:, None]
    sf = torch.where(hot_mask[:, None, None, :], sf, NEG_INF)
    m_h = sf.amax(-1)
    p_h = torch.exp(sf - m_h[..., None])
    l_h = p_h.sum(-1)
    acc_h = torch.einsum("bkgs,bskd->bkgd", p_h, hot_v.float())
    mx = torch.maximum(m_h, m_c)
    ch, cc = torch.exp(m_h - mx), torch.exp(m_c - mx)
    num = acc_h * ch[..., None] + acc_c * cc[..., None]
    den = l_h * ch + l_c * cc
    out = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, hd)
