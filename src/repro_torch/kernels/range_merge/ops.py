"""range_merge: the range engine's per-scan merge-dedup (paper 2.9).

`range_merge` takes Q candidate rows (Q, C), each holding P sorted
segments at run-time `offsets` (Q, P+1), and returns the rows in global
(key, seq) order — ties to the later segment, then by position — with
the weighted survivor keep mask and the payload (0 on KEY_EMPTY lanes),
as the reference's `range_merge_op` does.

`range_merge` is the kernel's wrapper: for CUDA tensors it launches
`csrc/range_merge.cu`'s one-pass merge (one launch when a row fits a
tile of RANGE_TILE lanes, else a split and a merge launch; counted in
`range_merge.launches`), for CPU tensors it runs `range_merge_plain`,
one stable sort of that order.

The reference's own form stays as the contract: `range_merge_rounds`
pads the segment count to a power of two and runs log2 of it rounds of
`merge_round` (pairwise segment merges over the (key, weight, seq,
source-index) lanes, the last emitting the keep mask), then gathers the
payload. `merge_round` launches the round kernel on the card (counted in
`merge_round.launches`) and runs `merge_round_plain` on the CPU;
`range_merge` never calls it.
"""
from __future__ import annotations

import torch

from repro_torch.core import runs as RU
from repro_torch.core.params import KEY_EMPTY
from repro_torch.kernels import _build

_KEY_EMPTY = int(KEY_EMPTY)
_COMP_MAX = torch.iinfo(torch.int64).max


def _pair_of_lane(off: torch.Tensor, c_n: int) -> torch.Tensor:
    """(Q, C) index of the segment pair each lane of a row falls in:
    `upper_bound` over the paired boundaries off[:, 0::2], minus one,
    clamped to a pair."""
    paired = off[:, 0::2].contiguous()
    t = torch.arange(c_n, dtype=torch.int32, device=off.device)
    p = torch.searchsorted(paired, t.expand(off.shape[0], -1).contiguous(),
                           right=True) - 1
    return p.clamp(0, (off.shape[1] - 1) // 2 - 1)


def _keep_mask(mk, mw, pad, drop: bool):
    """The weighted survivor mask of merged rows: a lane is kept iff it
    is not padding or KEY_EMPTY, the next lane has another key, and,
    when `drop`, its weight is positive."""
    nxt = torch.cat([mk[:, 1:], mk.new_full((mk.shape[0], 1), _KEY_EMPTY)],
                    dim=1)
    keep = ~pad & (mk != _KEY_EMPTY) & (mk != nxt)
    return keep & (mw > 0) if drop else keep


def merge_round_plain(k, w, s, ix, off, final: bool, drop: bool):
    """Plain PyTorch version of one round. Within each pair the merged
    order is the order of (key, seq) with ties going to the second
    segment, i.e. a stable sort by (pair, key-seq composite, side) —
    taken as three stable sorts, least significant first. Lanes past
    off[:, -1] come out (KEY_EMPTY, 0, 0, 0). Returns (k, w, s, ix) and,
    when `final`, the keep mask."""
    q_n, c_n = k.shape
    total = off[:, -1:].to(torch.int64)
    t = torch.arange(c_n, device=k.device).expand(q_n, -1)
    p = _pair_of_lane(off, c_n)
    a_hi = off.gather(1, 2 * p + 1)
    side_b = t >= a_hi                       # lane lies in the second half
    pad = t >= total
    p = torch.where(pad, off.shape[1], p)    # padding sorts last
    order = torch.sort((~side_b).to(torch.int8), dim=1, stable=True).indices
    comp = RU.composite(k, s).gather(1, order)
    order = order.gather(1, torch.sort(comp, dim=1, stable=True).indices)
    order = order.gather(1, torch.sort(p.gather(1, order), dim=1,
                                       stable=True).indices)
    outs = [torch.where(pad, fill, a.gather(1, order))
            for a, fill in ((k, _KEY_EMPTY), (w, 0), (s, 0), (ix, 0))]
    if not final:
        return tuple(outs)
    return (*outs, _keep_mask(outs[0], outs[1], pad, drop))


def merge_round(k, w, s, ix, off, final: bool, drop: bool):
    """One round over (Q, C) int32 lanes with (Q, S+1) int32 segment
    boundaries, S even >= 2. Returns the merged lanes, plus the keep
    mask when `final`."""
    if k.device.type == "cpu":
        return merge_round_plain(k, w, s, ix, off, final, drop)
    dev = k.device
    lanes = (k, w, s, ix)
    if dev.type != "cuda" or any(a.device != dev for a in lanes + (off,)):
        raise ValueError("range_merge: tensors must share one CUDA device "
                         "(or all lie on the CPU)")
    if any(a.dtype != torch.int32 or a.shape != k.shape or a.dim() != 2
           or not a.is_contiguous() for a in lanes):
        raise ValueError("range_merge: four contiguous (Q, C) int32 lanes "
                         "expected")
    s_n = off.shape[1] - 1
    if (off.dtype != torch.int32 or not off.is_contiguous()
            or off.shape[0] != k.shape[0] or s_n < 2 or s_n % 2):
        raise ValueError("range_merge: contiguous (Q, S+1) int32 offsets "
                         "with S even >= 2 expected")
    q_n, c_n = k.shape
    outs = tuple(torch.empty_like(a) for a in lanes)
    keep = (torch.empty((q_n, c_n), dtype=torch.bool, device=dev)
            if final else None)
    fn = _build.bind("range_merge", "range_merge_round_launch", 10, 4)
    _build.check(fn(*(a.data_ptr() for a in lanes), off.data_ptr(),
                    *(o.data_ptr() for o in outs),
                    keep.data_ptr() if final else None, q_n, c_n, s_n,
                    int(drop), torch.cuda.current_stream(dev).cuda_stream),
                 "range_merge")
    merge_round.launches += 1
    return (*outs, keep) if final else outs


merge_round.launches = 0


def tournament(k, w, s, ix, offsets, drop: bool, round_fn=None):
    """All rounds of `round_fn` (default `merge_round`) over rows whose
    segment count is a power of two >= 2: returns the merged
    (k, w, s, ix) and the keep mask."""
    round_fn = round_fn or merge_round
    off = offsets
    while off.shape[1] - 1 > 2:
        k, w, s, ix = round_fn(k, w, s, ix, off, False, drop)
        off = off[:, ::2].contiguous()
    return round_fn(k, w, s, ix, off, True, drop)


def range_merge_rounds(keys, vals, wts, seqs, offsets,
                       drop_annihilated: bool, round_fn=None):
    """The reference's form of `range_merge`: the segment count padded
    to a power of two (appended segments are empty: their boundary
    repeats the last one), the `tournament` of rounds, then one payload
    gather through the source-index lane, 0 on KEY_EMPTY lanes."""
    q_n, c_n = keys.shape
    n_seg = offsets.shape[1] - 1
    s0 = max(2, 1 << (n_seg - 1).bit_length())
    off = offsets.to(torch.int32)
    if s0 != n_seg:
        off = torch.cat([off, off[:, -1:].expand(-1, s0 - n_seg)], dim=1)
    ix = torch.arange(c_n, dtype=torch.int32,
                      device=keys.device).expand(q_n, -1).contiguous()
    mk, mw, ms, mi, keep = tournament(
        keys.contiguous(), wts.contiguous(), seqs.contiguous(), ix,
        off.contiguous(), drop_annihilated, round_fn)
    mv = vals.gather(1, mi.long())
    mv = torch.where(mk == _KEY_EMPTY, 0, mv)
    return mk, mv, mw, ms, keep


def range_merge_plain(keys, vals, wts, seqs, offsets,
                      drop_annihilated: bool):
    """Plain PyTorch version of `range_merge`: one stable sort of the
    (key, seq) composite over each row's lanes taken last segment
    first — the rounds' order, where ties go to the later segment and
    then to the lower position. Lanes past offsets[:, P] are padding:
    they sort last and come out (KEY_EMPTY, 0, 0, 0), not kept."""
    q_n, c_n = keys.shape
    off = offsets.to(torch.int64)
    t = torch.arange(c_n, device=keys.device).expand(q_n, -1)
    total = off[:, -1:]
    pad = t >= total
    seg = (torch.searchsorted(off, t.contiguous(), right=True) - 1).clamp(
        0, off.shape[1] - 2)
    # lane t of segment g sits at total - off[g + 1] + (t - off[g]) when
    # the segments are laid out last first; padding stays where it is
    rev = torch.where(pad, t, total - off.gather(1, seg + 1)
                      + t - off.gather(1, seg))
    lane = torch.empty((q_n, c_n), dtype=torch.int64,
                       device=keys.device).scatter_(1, rev, t)
    comp = torch.where(pad, _COMP_MAX, RU.composite(keys, seqs))
    order = torch.sort(comp.gather(1, lane), dim=1, stable=True).indices
    src = lane.gather(1, order)
    mk, mv, mw, ms = (torch.where(pad, fill, a.gather(1, src))
                      for a, fill in ((keys, _KEY_EMPTY), (vals, 0),
                                      (wts, 0), (seqs, 0)))
    mv = torch.where(mk == _KEY_EMPTY, 0, mv)
    return mk, mv, mw, ms, _keep_mask(mk, mw, pad, drop_annihilated)


RANGE_TILE = 2048           # merged lanes a CTA holds (two buffers of 16 B)
RANGE_SAMPLE_BYTES = 192 * 1024  # a row's samples a split CTA merges (32 B)
RANGE_SPLIT_IN_PLACE = 264  # split CTAs a row when samples stay in place


def range_geometry(c_n: int, n_seg: int):
    """(tile, step S, group G, tiles, shared, split_ctas) of the kernel
    for rows of `c_n` lanes in `n_seg` segments. A row of at most
    RANGE_TILE lanes is one tile (S = 0: no split launch). A wider row
    samples every S-th lane of each segment and bounds a tile at every
    G-th sample in merged order, so a tile holds at most S * (G + P) <=
    RANGE_TILE lanes and a row at most `tiles` tiles. S doubles while a
    row's samples miss RANGE_SAMPLE_BYTES and G stays positive; `shared`
    says whether they fit there (one split CTA a row merges them; else
    `split_ctas` CTAs a row rank them in place). Up to RANGE_TILE / 2
    segments; more raise."""
    if c_n <= RANGE_TILE:
        return c_n, 0, 0, 1, False, 0
    if not 1 <= n_seg <= RANGE_TILE // 2:
        raise ValueError(f"range_merge: rows wider than {RANGE_TILE} lanes "
                         f"take 1 to {RANGE_TILE // 2} segments, not "
                         f"{n_seg}")
    step = 1 << ((RANGE_TILE // (2 * n_seg)).bit_length() - 1)

    def samples(step):
        return -(-c_n // step) + n_seg

    def fits(step):
        return 32 * samples(step) <= RANGE_SAMPLE_BYTES
    while not fits(step) and RANGE_TILE // (2 * step) > n_seg:
        step *= 2
    group = RANGE_TILE // step - n_seg
    shared = fits(step)
    ctas = 1 if shared else min(-(-samples(step) // 32),
                                RANGE_SPLIT_IN_PLACE)
    return (RANGE_TILE, step, group, -(-samples(step) // group), shared,
            ctas)


def range_merge(keys, vals, wts, seqs, offsets, drop_annihilated: bool):
    """Merge P sorted segments per candidate row. keys/vals/wts/seqs
    (Q, C) int32, offsets (Q, P+1) int32 segment boundaries,
    non-decreasing from 0 to at most C (lanes past offsets[:, P] are
    padding). Returns (keys, vals, wts, seqs, keep): rows in global
    (key, seq) order, `keep` marking the newest copy of every key
    (non-positive weights dropped when `drop_annihilated`)."""
    if keys.device.type == "cpu":
        return range_merge_plain(keys, vals, wts, seqs, offsets,
                                 drop_annihilated)
    dev = keys.device
    lanes = tuple(a.contiguous() for a in (keys, vals, wts, seqs))
    offsets = offsets.contiguous()
    if dev.type != "cuda" or any(a.device != dev
                                 for a in lanes + (offsets,)):
        raise ValueError("range_merge: tensors must share one CUDA device "
                         "(or all lie on the CPU)")
    if any(a.dtype != torch.int32 or a.dim() != 2 or a.shape != keys.shape
           for a in lanes):
        raise ValueError("range_merge: four (Q, C) int32 lanes expected")
    q_n, c_n = keys.shape
    n_seg = offsets.shape[1] - 1
    if (offsets.dtype != torch.int32 or offsets.dim() != 2
            or offsets.shape[0] != q_n or n_seg < 1):
        raise ValueError("range_merge: (Q, P+1) int32 offsets expected, "
                         "P >= 1")
    if q_n > 65535 or c_n >= 2 ** 31:
        raise ValueError(f"range_merge: at most 65,535 rows of < 2**31 "
                         f"lanes, not {q_n} x {c_n}")
    tile, step, group, tiles, shared, ctas = range_geometry(c_n, n_seg)
    outs = tuple(torch.empty_like(a) for a in lanes)
    keep = torch.empty((q_n, c_n), dtype=torch.bool, device=dev)
    split = (torch.empty(q_n * tiles * n_seg, dtype=torch.int32,
                         device=dev) if step else None)
    fn = _build.bind("range_merge", "range_merge_launch", 11, 10)
    _build.check(fn(*(a.data_ptr() for a in lanes), offsets.data_ptr(),
                    split.data_ptr() if step else None,
                    *(o.data_ptr() for o in outs), keep.data_ptr(), q_n,
                    c_n, n_seg, tile, step, group, tiles, ctas, int(shared),
                    int(drop_annihilated),
                    torch.cuda.current_stream(dev).cuda_stream),
                 "range_merge")
    range_merge.launches += 2 if step else 1
    return (*outs, keep)


range_merge.launches = 0


def work(rows: int, lanes: int, filled: int, parts: int
         ) -> tuple[float, float]:
    """(FLOPs, bytes) of one call over `rows` rows of `lanes` lanes: the
    `filled` lanes that hold records (16 bytes each, this call's data),
    the int32 offsets of `parts` segments a row, and every output lane
    (16 bytes and a flag) written once. Integer work: 0 FLOPs."""
    return 0.0, float(filled * 16 + rows * (parts + 1) * 4
                      + rows * lanes * 17)
