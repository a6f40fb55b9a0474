"""range_merge: the range engine's per-scan merge-dedup (paper 2.9).

`range_merge` takes Q candidate rows (Q, C), each holding P sorted
segments at run-time `offsets` (Q, P+1), and returns the rows in global
(key, seq) order with the weighted survivor keep mask, as the
reference's `range_merge_op` does: the segment count is padded to a
power of two with repeated (empty) boundaries, log2 of it rounds merge
adjacent segment pairs over the (key, weight, seq, source-index) lanes,
the final round emits the keep mask, and the payload is gathered once
afterwards and forced to 0 on KEY_EMPTY lanes.

Each round is one call of `merge_round`, the kernel's wrapper: it
launches `csrc/range_merge.cu` for CUDA tensors (counted in
`merge_round.launches`) and runs `merge_round_plain` for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import runs as RU
from repro_torch.core.params import KEY_EMPTY
from repro_torch.kernels import _build

_KEY_EMPTY = int(KEY_EMPTY)


def _pair_of_lane(off: torch.Tensor, c_n: int) -> torch.Tensor:
    """(Q, C) index of the segment pair each lane of a row falls in:
    `upper_bound` over the paired boundaries off[:, 0::2], minus one,
    clamped to a pair."""
    paired = off[:, 0::2].contiguous()
    t = torch.arange(c_n, dtype=torch.int32, device=off.device)
    p = torch.searchsorted(paired, t.expand(off.shape[0], -1).contiguous(),
                           right=True) - 1
    return p.clamp(0, (off.shape[1] - 1) // 2 - 1)


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
    mk, mw = outs[0], outs[1]
    nxt = torch.cat([mk[:, 1:], mk.new_full((q_n, 1), _KEY_EMPTY)], dim=1)
    keep = ~pad & (mk != _KEY_EMPTY) & (mk != nxt)
    if drop:
        keep &= mw > 0
    return (*outs, keep)


def merge_round(k, w, s, ix, off, final: bool, drop: bool):
    """One tournament round over (Q, C) int32 lanes with (Q, S+1) int32
    segment boundaries, S even >= 2. Returns the merged lanes, plus the
    keep mask when `final`."""
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


def range_merge(keys, vals, wts, seqs, offsets, drop_annihilated: bool):
    """Merge P sorted segments per candidate row. keys/vals/wts/seqs
    (Q, C) int32, offsets (Q, P+1) int32 exclusive segment boundaries
    (lanes past offsets[:, P] are padding). Returns (keys, vals, wts,
    seqs, keep): rows in global (key, seq) order, `keep` marking the
    newest copy of every key (non-positive weights dropped when
    `drop_annihilated`)."""
    q_n, c_n = keys.shape
    n_seg = offsets.shape[1] - 1
    # pad the segment count to a power of two (appended segments are
    # empty: their boundary repeats the last one)
    s0 = max(2, 1 << (n_seg - 1).bit_length())
    off = offsets.to(torch.int32)
    if s0 != n_seg:
        off = torch.cat([off, off[:, -1:].expand(-1, s0 - n_seg)], dim=1)
    ix = torch.arange(c_n, dtype=torch.int32,
                      device=keys.device).expand(q_n, -1).contiguous()
    mk, mw, ms, mi, keep = tournament(
        keys.contiguous(), wts.contiguous(), seqs.contiguous(), ix,
        off.contiguous(), drop_annihilated)
    # payload gather — one pass, after the tournament; KEY_EMPTY lanes 0
    mv = vals.gather(1, mi.long())
    mv = torch.where(mk == _KEY_EMPTY, 0, mv)
    return mk, mv, mw, ms, keep
