"""lsm_attention: single-token GQA decode attention over a KV cache, and
the sLSM-tiered op built on it (port of `repro.kernels.lsm_attention`).

One kernel, `csrc/lsm_attention.cu`, behind three entry points; each
launches it for CUDA tensors and runs a plain version for CPU tensors:

  decode_attention        — q, k, v and an int8 validity bitmap: the
                            Pallas kernel's own contract
  decode_attention_op     — dense (ragged) cache, validity from lengths
  lsm_decode_attention    — the tiered cache read in place: the hot
                            window below hot_len, then the selected cold
                            blocks (ids, ok) straight from the block store

and, around them, as in the reference's `ops.py`:

  select_blocks           — score cold blocks by q . summary, top-k
  lsm_decode_attention_op — select, then `lsm_decode_attention`

Two inputs take other paths, never the plain version in place of the
kernel. DTensors (a mesh) run each rank's call on its `to_local()`
shards: the batch and the kv heads keep their sharding where every input
has it on a mesh axis, and any other axis is gathered first
(`_per_rank`). `FakeTensor`s run nothing, and only inside a cost
counter (`shape_only.active`; outside one they raise): the entry point
returns an empty output of the kernel's shape and dtype and records the
kernel's `work` (every row the call may read) with the counter.

Every launch, whichever entry point, adds one to
`decode_attention.launches`; the tiered entry point's also add one to
`lsm_decode_attention.launches`. On the card the tiered path builds no
`[hot | selected]` copy and no bitmap: the kernel resolves each row
from (hot_len, ids, ok) and never reads a row that is not valid. Its
plain version is the straightforward one — `tiered_inputs` (gather,
concatenate, bitmap) then `decode_attention_plain`. Unlike the Pallas
kernel, nothing pads L to a multiple of 512 (a TPU tiling artefact that
would copy the whole cache each step).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch import shape_only
from repro_torch.kernels import _build

NEG_INF = -1e30
TARGET_CTAS = 528         # 4 per SM of the H100's 132 (tuned on the card)
TILE_ROWS = 32            # rows a kernel tile; chunks are multiples of it
MIN_CHUNK = 128           # fewest positions a CTA takes
MAX_SPLITS = 1024         # the merge kernel keeps one factor a split
HEAD_DIMS = (16, 64, 128, 256)
BITMAP, LENGTHS, TIERED = 0, 1, 2         # the kernel's addressing modes


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel (`_decode_attn_kernel`):
    q (B, H, dh); k, v (B, L, KV, dh); valid (B, KV, L) int8 -> (B, H, dh)
    in q's dtype. f32 math; a row with no valid position gives 0. Rows
    that are not valid never reach the output, whatever they hold (NaN
    included), as the kernel never reads them."""
    b, h, dh = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, kv, h // kv, dh)
    s = torch.einsum("bkgd,blkd->bkgl", qg, k.float()) * scale
    ok = valid != 0                                       # (B, KV, L)
    s = torch.where(ok[:, :, None, :], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(ok[:, :, None, :], torch.exp(s - m), 0.0)
    den = p.sum(-1).clamp_min(1e-30)
    vf = torch.where(ok.transpose(1, 2)[..., None], v.float(), 0.0)
    out = torch.einsum("bkgl,blkd->bkgd", p, vf) / den[..., None]
    return out.reshape(b, h, dh).to(q.dtype)


def _splits(b: int, groups: int, length: int) -> tuple[int, int]:
    """(splits, chunk): L cut into `splits` chunks of `chunk` positions (a
    multiple of the kernel's tile), enough CTAs to fill the card, no
    chunk under MIN_CHUNK."""
    want = max(1, -(-TARGET_CTAS // (b * groups)))
    splits = max(1, min(want, -(-length // MIN_CHUNK), MAX_SPLITS))
    chunk = -(-length // splits)
    chunk = -(-chunk // TILE_ROWS) * TILE_ROWS
    return -(-length // chunk), chunk


@functools.lru_cache(maxsize=64)
def _tiered_chunk(b: int, groups: int, w: int, mu: int, topk: int) -> int:
    """The largest chunk that divides both W and mu (so a CTA's rows lie
    in one segment) and still gives TARGET_CTAS, within MAX_SPLITS; no
    chunk under one tile unless gcd(W, mu) is. Cached: decode asks for
    the same shape in every layer of every step."""
    g = math.gcd(w, mu)
    divs = [c for c in range(min(g, TILE_ROWS), g + 1) if g % c == 0]
    virt = w + topk * mu
    fits = [c for c in divs if virt // c <= MAX_SPLITS]
    if not fits:
        raise ValueError(f"lsm_attention: W={w}, mu={mu}, topk={topk} need "
                         f"over {MAX_SPLITS} chunks")
    full = [c for c in fits if b * groups * (virt // c) >= TARGET_CTAS]
    return max(full) if full else min(fits)


def _check_qkv(what: str, q, k, v, seq_dim: int):
    """Device, dtype, shape and alignment checks shared by the entry
    points; returns (per_pass, groups)."""
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v)):
        raise ValueError(f"{what}: tensors must share one CUDA device (or "
                         "all lie on the CPU)")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{what}: q, k, v all f32 or all bf16 expected")
    b, h, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[-1] != dh \
            or k.dim() != seq_dim + 3:
        raise ValueError(f"{what}: k, v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    kv = k.shape[-2]
    if h % kv:
        raise ValueError(f"{what}: H % KV == 0 expected")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {dh} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{what}: contiguous tensors expected")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what}: q, k, v must start on 16 bytes (the "
                         "kernel copies 16-byte chunks)")
    group = h // kv
    per_pass = next(p for p in (4, 3, 2, 1) if group % p == 0)
    return per_pass, kv * (group // per_pass)


def _launch(mode: int, q, k, v, *, valid=None, lens=None, blk_k=None,
            blk_v=None, ids=None, ok=None, length: int, splits: int,
            chunk: int, per_pass: int, scale: float, nb: int = 0,
            mu: int = 0, topk: int = 0) -> torch.Tensor:
    b, h, dh = q.shape
    n_part = b * h * splits
    m_scr = torch.empty(n_part, dtype=torch.float32, device=q.device)
    l_scr = torch.empty_like(m_scr)
    acc = torch.empty(n_part * dh, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    fn = _build.bind("lsm_attention", "lsm_attention_launch", 13, 13, 1)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(blk_k),
                    ptr(blk_v), ptr(valid), ptr(lens), ptr(ids), ptr(ok),
                    out.data_ptr(), m_scr.data_ptr(), l_scr.data_ptr(),
                    acc.data_ptr(), mode, b, h, k.shape[-2], length, dh,
                    int(q.dtype == torch.bfloat16), nb, mu, topk, splits,
                    chunk, per_pass, float(scale),
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "lsm_attention")
    decode_attention.launches += 1
    if mode == TIERED:
        _tiered_entry.launches += 1
    return out


def _mesh_of(*ts):
    """The mesh of the first DTensor among `ts`, or None."""
    from torch.distributed.tensor import DTensor
    return next((t.device_mesh for t in ts if isinstance(t, DTensor)), None)


# (batch dim, kv-head dim) of each input kind; q's heads are kv-major, so
# its head dim shards with the kv heads
_Q, _DENSE_KV, _BY_KV, _BLOCKS, _ROWS = (0, 1), (0, 2), (0, 1), (0, 3), \
    (0, None)


def _per_rank(entry, mesh, tensors, dims, out_dims=_Q, **kw):
    """`entry` on each rank's shards of DTensor `tensors` (q first;
    plain tensors join as replicated), laid out by q: over a mesh axis
    that shards q's batch every input is sharded on its batch, over one
    that shards q's heads every input with kv heads on them (q's heads
    are kv-major), and over any other every input is gathered first (a
    kernel call reads whole rows and whole head groups). -> the result
    (a tensor or a tuple) as DTensors laid out by `out_dims`, q's layout
    unless given."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    q = tensors[0]
    modes = [None] * mesh.ndim
    if isinstance(q, DTensor):
        modes = ["batch" if p == Shard(0) else "heads" if p == Shard(1)
                 else None for p in q.placements]

    def layout(d):
        return tuple(Shard(d[0]) if m == "batch" else
                     Shard(d[1]) if m == "heads" and d[1] is not None
                     else Replicate() for m in modes)
    local = []
    for t, d in zip(tensors, dims):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        local.append(t.redistribute(mesh, layout(d)).to_local())
    out = entry(*local, **kw)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, layout(out_dims),
                                        run_check=False) for o in out)
    return DTensor.from_local(out, mesh, layout(out_dims), run_check=False)


def _fake_call(q, rows: int, **shape) -> torch.Tensor:
    """The kernel's output, empty, and its work recorded."""
    b, h, dh = q.shape
    shape_only.record_kernel("lsm_attention", *work(
        b=b, h=h, dh=dh, rows=rows, elt=q.element_size(), **shape))
    return torch.empty_like(q)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B, H, dh); k, v (B, L, KV, dh); valid (B, KV, L) int8 ->
    (B, H, dh) in q's dtype. Any L >= 1; q, k, v share one dtype."""
    mesh = _mesh_of(q, k, v, valid)
    if mesh is not None:
        return _per_rank(decode_attention, mesh, (q, k, v, valid),
                         (_Q, _DENSE_KV, _DENSE_KV, _BY_KV), scale=scale)
    if shape_only.active(q, k, v, valid):
        b, length, kv = k.shape[:3]
        return _fake_call(q, b * kv * length, kv=kv, mode="bitmap",
                          length=length)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid, scale)
    per_pass, groups = _check_qkv("decode_attention", q, k, v, 1)
    b, length, kv = k.shape[:3]
    if valid.device != q.device or valid.dtype != torch.int8 \
            or valid.shape != (b, kv, length) or not valid.is_contiguous():
        raise ValueError(f"decode_attention: contiguous int8 valid (B, KV, "
                         f"L) = {(b, kv, length)} expected")
    splits, chunk = _splits(b, groups, length)
    return _launch(BITMAP, q, k, v, valid=valid, length=length,
                   splits=splits, chunk=chunk, per_pass=per_pass,
                   scale=scale)


decode_attention.launches = 0


def decode_attention_op(q, k, v, lengths, scale: float) -> torch.Tensor:
    """q (B, H, dh); k, v (B, L, KV, dh); lengths (B,) -> (B, H, dh):
    position l of row b is valid when l < lengths[b]. On the card the
    kernel reads `lengths` itself; no bitmap is built."""
    mesh = _mesh_of(q, k, v, lengths)
    if mesh is not None:
        return _per_rank(decode_attention_op, mesh, (q, k, v, lengths),
                         (_Q, _DENSE_KV, _DENSE_KV, _ROWS), scale=scale)
    b, length, kv = k.shape[:3]
    if shape_only.active(q, k, v, lengths):
        return _fake_call(q, b * kv * length, kv=kv, mode="lengths")
    if q.device.type == "cpu":
        valid = torch.arange(length)[None, :] < lengths[:, None]
        valid = valid[:, None, :].expand(b, kv, length).to(torch.int8)
        return decode_attention_plain(q, k, v, valid, scale)
    per_pass, groups = _check_qkv("decode_attention_op", q, k, v, 1)
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if lens.shape != (b,):
        raise ValueError(f"decode_attention_op: lengths ({b},) expected")
    splits, chunk = _splits(b, groups, length)
    return _launch(LENGTHS, q, k, v, lens=lens, length=length,
                   splits=splits, chunk=chunk, per_pass=per_pass,
                   scale=scale)


def select_blocks(q, summaries, n_blocks, topk: int, groups: int = 1):
    """Top-k cold blocks per kv head by max over the head's query group
    of q . summary, in f32 (blocks at or past n_blocks score -inf).

    q (B, H, dh); summaries (B, NB, KV, dh); n_blocks (B,)
    -> ids (B, KV, topk) int64, ok (B, KV, topk) bool

    With `groups` G > 1 (the reference's hierarchical selection,
    `lsm_dp_groups`; G must divide NB and topk <= NB / G): a top-k in
    each group of NB / G consecutive blocks, then a global threshold,
    the k-th largest of the G * topk candidates. ids (B, KV, G * topk)
    are global block ids, group by group; ok admits a candidate whose
    score is finite and at least the threshold, so exactly the global
    top-k blocks (and any ties with the k-th) are attended, as without
    groups.
    """
    mesh = _mesh_of(q, summaries, n_blocks)
    if mesh is not None:       # per rank, as the kernel's entry points
        return _per_rank(select_blocks, mesh, (q, summaries, n_blocks),
                         (_Q, _DENSE_KV, _ROWS), out_dims=_BY_KV, topk=topk,
                         groups=groups)
    b, h, dh = q.shape
    nb, kv = summaries.shape[1:3]
    qg = q.float().reshape(b, kv, h // kv, dh)
    score = torch.einsum("bkgd,bnkd->bkgn", qg,
                         summaries.float()).amax(dim=2)     # (B, KV, NB)
    blk_ok = torch.arange(nb, device=q.device)[None, :] < n_blocks[:, None]
    score = torch.where(blk_ok[:, None, :], score, -torch.inf)
    if groups == 1:
        top, ids = torch.topk(score, topk, dim=-1)
        return ids, torch.isfinite(top)
    nbl = nb // groups
    loc_s, loc_i = torch.topk(score.reshape(b, kv, groups, nbl), topk,
                              dim=-1)                       # (B,KV,G,topk)
    flat_s = loc_s.reshape(b, kv, groups * topk)
    kth = torch.topk(flat_s, topk, dim=-1).values[..., -1:]
    base = torch.arange(groups, device=q.device)[:, None] * nbl
    ids = (loc_i + base).reshape(b, kv, groups * topk)
    return ids, torch.isfinite(flat_s) & (flat_s >= kth)


def tiered_inputs(hot_k, hot_v, hot_len, blk_k, blk_v, ids, ok):
    """`[hot | selected]` as one K/V pair and its validity bitmap (the
    tiered plain version's input; the kernel reads in place).

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


def lsm_decode_attention_plain(q, hot_k, hot_v, hot_len, blk_k, blk_v,
                               ids, ok, scale: float) -> torch.Tensor:
    """Plain version of the tiered entry point: `[hot | selected]` and its
    bitmap built by `tiered_inputs`, then `decode_attention_plain`."""
    k, v, valid = tiered_inputs(hot_k, hot_v, hot_len, blk_k, blk_v, ids, ok)
    return decode_attention_plain(q, k, v, valid, scale)


def lsm_decode_attention(q, hot_k, hot_v, hot_len, blk_k, blk_v, ids, ok,
                         scale: float) -> torch.Tensor:
    """Tiered decode attention read in place: position p < W is hot row p,
    valid when p < hot_len[b]; position W + t*mu + r is row r of block
    ids[b, kv, t], valid when ok[b, kv, t].

    q (B, H, dh); hot_k/v (B, W, KV, dh), hot_len (B,) int32; blk_k/v
    (B, NB, mu, KV, dh); ids (B, KV, topk) int64, ok (B, KV, topk) bool
    -> (B, H, dh) in q's dtype. On the card one kernel call; no row of an
    invalid position is read, so those rows may hold anything. Its
    launches count on `decode_attention.launches` and, apart, on
    `lsm_decode_attention.launches`."""
    args = (q, hot_k, hot_v, hot_len, blk_k, blk_v, ids, ok)
    mesh = _mesh_of(*args)
    if mesh is not None:
        return _per_rank(lsm_decode_attention, mesh, args,
                         (_Q, _DENSE_KV, _DENSE_KV, _ROWS, _BLOCKS, _BLOCKS,
                          _BY_KV, _BY_KV), scale=scale)
    if shape_only.active(*args):
        b, w, kv = hot_k.shape[:3]
        topk = ids.shape[-1]
        return _fake_call(q, b * kv * (w + topk * blk_k.shape[2]), kv=kv,
                          mode="tiered", topk=topk)
    if q.device.type == "cpu":
        return lsm_decode_attention_plain(q, hot_k, hot_v, hot_len, blk_k,
                                          blk_v, ids, ok, scale)
    per_pass, groups = _check_qkv("lsm_decode_attention", q, hot_k, hot_v, 1)
    _check_qkv("lsm_decode_attention", q, blk_k, blk_v, 2)
    b, w, kv = hot_k.shape[:3]
    nb, mu = blk_k.shape[1:3]
    topk = ids.shape[-1]
    if ids.dtype != torch.int64 or ok.dtype != torch.bool \
            or ids.shape != (b, kv, topk) or ok.shape != ids.shape \
            or hot_len.dtype != torch.int32 or hot_len.shape != (b,) \
            or any(t.device != q.device or not t.is_contiguous()
                   for t in (ids, ok, hot_len)):
        raise ValueError("lsm_decode_attention: contiguous ids (B, KV, "
                         "topk) int64, ok bool and hot_len (B,) int32 on "
                         "q's device expected")
    chunk = _tiered_chunk(b, groups, w, mu, topk)
    return _launch(TIERED, q, hot_k, hot_v, lens=hot_len, blk_k=blk_k,
                   blk_v=blk_v, ids=ids, ok=ok, length=w,
                   splits=w // chunk + topk * mu // chunk, chunk=chunk,
                   per_pass=per_pass, scale=scale, nb=nb, mu=mu, topk=topk)


lsm_decode_attention.launches = 0
_tiered_entry = lsm_decode_attention     # its counter, if the name is rebound


def lsm_decode_attention_op(q, hot_k, hot_v, hot_len, blk_k, blk_v,
                            summaries, n_blocks, topk: int,
                            scale: float) -> torch.Tensor:
    """Tiered decode attention: the hot window (memory buffer) plus the
    top-k summary-gated cold blocks, read in place by one kernel call.

    q (B, H, dh); hot_k/v (B, W, KV, dh), hot_len (B,); blk_k/v
    (B, NB, mu, KV, dh); summaries (B, NB, KV, dh), n_blocks (B,)
    -> (B, H, dh)
    """
    ids, ok = select_blocks(q, summaries, n_blocks, topk)
    return lsm_decode_attention(q, hot_k, hot_v, hot_len.to(torch.int32),
                                blk_k, blk_v, ids, ok, scale)


def work(b: int, h: int, kv: int, dh: int, rows: int, elt: int, mode: str,
         topk: int = 0, length: int = 0) -> tuple[float, float]:
    """(FLOPs, bytes) of one call, each input byte it needs read once and
    each output byte written once: K and V of its `rows` valid (batch,
    kv head, position) rows, q and the output (`elt` bytes an element),
    and what locates the rows — the lengths (mode "lengths"), the int8
    bitmap of `length` positions ("bitmap"), or hot_len and the tiered
    ids and ok of `topk` blocks ("tiered"). FLOPs 4·rows·(h / kv)·dh
    (q·k and p·v)."""
    if mode == "lengths":
        extra = 2 * b * 4
    elif mode == "tiered":
        n_sel = b * kv * topk
        extra = n_sel * 8 + n_sel + b * 4
    elif mode == "bitmap":
        extra = b * kv * length
    else:
        raise ValueError(f"lsm_attention mode {mode!r}")
    n_bytes = 2 * rows * dh * elt + 2 * b * h * dh * elt + extra
    return float(4 * rows * (h // kv) * dh), float(n_bytes)
