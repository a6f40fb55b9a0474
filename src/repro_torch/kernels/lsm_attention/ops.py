"""lsm_attention: single-token GQA decode attention over a KV cache, and
the sLSM-tiered op built on it (port of `repro.kernels.lsm_attention`).

`decode_attention` launches `csrc/lsm_attention.cu` for CUDA tensors and
runs `decode_attention_plain` for CPU tensors. It counts its launches in
`decode_attention.launches`. Around it, as in the reference's `ops.py`:

  decode_attention_op     — dense (ragged) cache, validity from lengths
  select_blocks           — score cold blocks by q . summary, top-k
  lsm_decode_attention_op — select, gather, `[hot | selected]`, one call

The cold-block gather is a plain index op: the kernel gets the hot
window and the selected blocks as one K/V tensor and one bitmap. Unlike
the Pallas kernel, nothing pads L to a multiple of 512 (a TPU tiling
artefact that would copy the whole cache each step).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
TARGET_CTAS = 1056        # ~8 resident CTAs on each of the H100's 132 SMs
MIN_CHUNK = 64            # fewest positions a CTA takes
MAX_SPLITS = 1024         # the merge kernel keeps one factor a split
HEAD_DIMS = (16, 64, 128, 256)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel (`_decode_attn_kernel`):
    q (B, H, dh); k, v (B, L, KV, dh); valid (B, KV, L) int8 -> (B, H, dh)
    in q's dtype. f32 math; a row with no valid position gives 0."""
    b, h, dh = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, kv, h // kv, dh)
    s = torch.einsum("bkgd,blkd->bkgl", qg, k.float()) * scale
    ok = (valid != 0)[:, :, None, :]                      # (B, KV, 1, L)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    den = p.sum(-1).clamp_min(1e-30)
    out = torch.einsum("bkgl,blkd->bkgd", p, v.float()) / den[..., None]
    return out.reshape(b, h, dh).to(q.dtype)


def _splits(b: int, groups: int, length: int) -> tuple[int, int]:
    """(splits, chunk): L cut into `splits` chunks of `chunk` positions,
    enough CTAs to fill the card, no chunk under MIN_CHUNK."""
    want = max(1, -(-TARGET_CTAS // (b * groups)))
    splits = max(1, min(want, -(-length // MIN_CHUNK), MAX_SPLITS))
    chunk = -(-length // splits)
    return -(-length // chunk), chunk


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B, H, dh); k, v (B, L, KV, dh); valid (B, KV, L) int8 ->
    (B, H, dh) in q's dtype. Any L >= 1; q, k, v share one dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid, scale)
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in (k, v, valid)):
        raise ValueError("decode_attention: q, k, v and valid must share "
                         "one CUDA device (or all lie on the CPU)")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype) or valid.dtype != torch.int8:
        raise TypeError("decode_attention: q, k, v all f32 or all bf16, "
                        "valid int8 expected")
    b, h, dh = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != dh:
        raise ValueError(f"decode_attention: k, v (B, L, KV, dh) expected, "
                         f"got {tuple(k.shape)}, {tuple(v.shape)}")
    length, kv = k.shape[1], k.shape[2]
    if valid.shape != (b, kv, length) or length < 1 or h % kv:
        raise ValueError(f"decode_attention: valid (B, KV, L) = "
                         f"{(b, kv, length)} and H % KV == 0 expected")
    if dh not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {dh} not in "
                         f"{HEAD_DIMS}")
    if not all(t.is_contiguous() for t in (q, k, v, valid)):
        raise ValueError("decode_attention: contiguous tensors expected")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention: q, k, v must start on 16 bytes "
                         "(the kernel loads 16-byte packs)")
    group = h // kv
    per_pass = next(p for p in (4, 3, 2, 1) if group % p == 0)
    splits, chunk = _splits(b, kv * (group // per_pass), length)
    n_part = b * h * splits
    m_scr = torch.empty(n_part, dtype=torch.float32, device=q.device)
    l_scr = torch.empty_like(m_scr)
    acc = torch.empty(n_part * dh, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    fn = _build.bind("lsm_attention", "lsm_attention_launch", 8, 9, 1)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    valid.data_ptr(), out.data_ptr(), m_scr.data_ptr(),
                    l_scr.data_ptr(), acc.data_ptr(), b, h, kv, length, dh,
                    int(q.dtype == torch.bfloat16), splits, chunk, per_pass,
                    float(scale),
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "lsm_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_op(q, k, v, lengths, scale: float) -> torch.Tensor:
    """q (B, H, dh); k, v (B, L, KV, dh); lengths (B,) -> (B, H, dh):
    position l of row b is valid when l < lengths[b]."""
    b, length, kv = k.shape[:3]
    valid = torch.arange(length, device=k.device)[None, :] < lengths[:, None]
    valid = valid[:, None, :].expand(b, kv, length).to(torch.int8)
    return decode_attention(q, k, v, valid.contiguous(), scale)


def select_blocks(q, summaries, n_blocks, topk: int):
    """Top-k cold blocks per kv head by max over the head's query group
    of q . summary, in f32 (blocks at or past n_blocks score -inf).

    q (B, H, dh); summaries (B, NB, KV, dh); n_blocks (B,)
    -> ids (B, KV, topk) int64, ok (B, KV, topk) bool
    """
    b, h, dh = q.shape
    nb, kv = summaries.shape[1:3]
    qg = q.float().reshape(b, kv, h // kv, dh)
    score = torch.einsum("bkgd,bnkd->bkgn", qg,
                         summaries.float()).amax(dim=2)     # (B, KV, NB)
    blk_ok = torch.arange(nb, device=q.device)[None, :] < n_blocks[:, None]
    score = torch.where(blk_ok[:, None, :], score, -torch.inf)
    top, ids = torch.topk(score, topk, dim=-1)
    return ids, torch.isfinite(top)


def tiered_inputs(hot_k, hot_v, hot_len, blk_k, blk_v, ids, ok):
    """`[hot | selected]` as one K/V pair and its validity bitmap.

    hot_k/v (B, W, KV, dh), hot_len (B,); blk_k/v (B, NB, mu, KV, dh);
    ids, ok (B, KV, topk) -> k, v (B, W + topk*mu, KV, dh), valid
    (B, KV, W + topk*mu) int8. The gather is a plain index op.
    """
    b, w, kv, dh = hot_k.shape
    mu = blk_k.shape[2]
    topk = ids.shape[-1]
    # block id of each (b, t, ., kv, .): one gather lands the selected
    # blocks in the (B, topk * mu, KV, dh) layout (the index is a
    # stride-0 view, never materialized)
    idx = ids.transpose(1, 2)[:, :, None, :, None].expand(b, topk, mu, kv,
                                                          dh)

    def tier(hot, blk):
        cold = torch.gather(blk, 1, idx).reshape(b, topk * mu, kv, dh)
        return torch.cat([hot, cold], dim=1)

    k_all, v_all = tier(hot_k, blk_k), tier(hot_v, blk_v)
    valid_hot = (torch.arange(w, device=ids.device)[None, :]
                 < hot_len[:, None])[:, None, :].expand(b, kv, w)
    valid_cold = ok.repeat_interleave(mu, dim=2)
    valid = torch.cat([valid_hot, valid_cold], dim=2).to(torch.int8)
    return k_all, v_all, valid


def lsm_decode_attention_op(q, hot_k, hot_v, hot_len, blk_k, blk_v,
                            summaries, n_blocks, topk: int,
                            scale: float) -> torch.Tensor:
    """Tiered decode attention: the hot window (memory buffer) plus the
    top-k summary-gated cold blocks, in one kernel call.

    q (B, H, dh); hot_k/v (B, W, KV, dh), hot_len (B,); blk_k/v
    (B, NB, mu, KV, dh); summaries (B, NB, KV, dh), n_blocks (B,)
    -> (B, H, dh)
    """
    ids, ok = select_blocks(q, summaries, n_blocks, topk)
    k, v, valid = tiered_inputs(hot_k, hot_v, hot_len, blk_k, blk_v, ids, ok)
    return decode_attention(q, k, v, valid, scale)
