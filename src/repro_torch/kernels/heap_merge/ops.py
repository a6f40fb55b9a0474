"""heap_merge: the k-way run merge (HeapMerge, paper 2.5).

`heap_merge` merges k sorted runs (k, cap) into one compacted run the
way the reference's `heap_merge_op` does: the (key, weight, seq,
source-index) lanes are merged — the reference runs log2(k) rounds of
two-way merges, an odd last run carried to the next round — then the
weighted survivor epilogue (newest record per key, annihilation when
`drop`), a stable compaction and one payload gather through the
survivors' source indices. The layout is identical to
`core.runs.merge_runs`.

The merge is one call of `kway_merge`, the kernel's wrapper: for CUDA
tensors it launches `csrc/heap_merge.cu`'s k-way merge (two kernels,
counted in `kway_merge.launches`), for CPU tensors it runs
`kway_merge_plain`. Both give the tournament's order exactly: a stable
sort by (key, seq), ties to the higher run, then by position. The
tournament itself stays as `tournament` over `merge_round` (one launch
a round, `merge_round.launches`), the reference's two-way contract. The
epilogue is PyTorch glue on both devices, as it was jnp glue around the
Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import runs as RU
from repro_torch.core.params import KEY_EMPTY
from repro_torch.kernels import _build

_KEY_EMPTY = int(KEY_EMPTY)


def round_pairs(bounds: list[int]) -> list[tuple[int, int, int]]:
    """(lo, mid, hi) of each pair of one round over runs laid back to back
    at `bounds` (n_runs + 1 boundaries); an odd last run pairs with an
    empty second half."""
    n_runs = len(bounds) - 1
    pairs = [(bounds[i], bounds[i + 1], bounds[i + 2])
             for i in range(0, n_runs - 1, 2)]
    if n_runs % 2:
        pairs.append((bounds[-2], bounds[-1], bounds[-1]))
    return pairs


def merge_round_plain(k, w, s, ix, pairs):
    """Plain PyTorch version of one round: each pair's two runs merged by
    a stable sort of the (key, seq) composite over the second run's lanes
    followed by the first's — the merge-path order, where ties go to the
    second run."""
    outs = [torch.empty_like(a) for a in (k, w, s, ix)]
    for lo, mid, hi in pairs:
        cat = [torch.cat([a[mid:hi], a[lo:mid]]) for a in (k, w, s, ix)]
        order = torch.sort(RU.composite(cat[0], cat[2]), stable=True).indices
        for out, a in zip(outs, cat):
            out[lo:hi] = a[order]
    return tuple(outs)


def merge_round(k, w, s, ix, pairs):
    """One tournament round: lanes (N,) int32 with runs back to back;
    `pairs` = list of (lo, mid, hi). Returns the four merged lanes."""
    if k.device.type == "cpu":
        return merge_round_plain(k, w, s, ix, pairs)
    dev = k.device
    lanes = (k, w, s, ix)
    if dev.type != "cuda" or any(a.device != dev for a in lanes):
        raise ValueError("heap_merge: lanes must share one CUDA device "
                         "(or all lie on the CPU)")
    if any(a.dtype != torch.int32 or a.dim() != 1 or not a.is_contiguous()
           or a.shape != k.shape for a in lanes):
        raise ValueError("heap_merge: four contiguous (N,) int32 lanes "
                         "expected")
    if not pairs or pairs[-1][2] > k.shape[0]:
        raise ValueError("heap_merge: pairs must lie inside the lanes")
    outs = tuple(torch.empty_like(a) for a in lanes)
    pt = torch.tensor(pairs, dtype=torch.int64, device=dev)
    longest = max(hi - lo for lo, _, hi in pairs)
    fn = _build.bind("heap_merge", "heap_merge_round_launch", 9, 2)
    _build.check(fn(*(a.data_ptr() for a in lanes), pt.data_ptr(),
                    *(o.data_ptr() for o in outs), len(pairs), longest,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "heap_merge")
    merge_round.launches += 1
    return outs


merge_round.launches = 0


KWAY_TILES = (1024, 2048)  # lanes a merge CTA holds (two buffers of 16 B)
KWAY_SMALL = 1 << 18       # merges of fewer lanes take the smaller tile
KWAY_SAMPLE_BYTES = 200 * 1024   # the samples a split CTA holds
KWAY_SPLIT_SAMPLES = 64    # samples a split CTA ranks (each copies all)
SPLIT_CTAS = 264           # split CTAs in place: 2 of 1,024 threads an SM


def _pitch(per_run: int) -> int:
    """A run's row of samples in shared memory (`sample_pitch`)."""
    return -(-per_run // 32) * 32 + 1


def kway_geometry(n_runs: int, cap: int):
    """(tile, step S, group G, tiles, shared) of the k-way kernel: every
    S-th lane of a run is a sample, every G-th sample in merged order
    bounds a tile, and a tile then holds fewer than S * (G + n_runs) <=
    `tile` lanes. S doubles while the samples miss KWAY_SAMPLE_BYTES and
    G stays positive; `shared` says whether they fit there (else
    the split kernel searches them in place). Up to half the larger
    tile's lanes in runs (1,024); more raise."""
    tile = KWAY_TILES[n_runs * cap >= KWAY_SMALL
                      or n_runs > KWAY_TILES[0] // 2]
    if not 1 <= n_runs <= tile // 2:
        raise ValueError(f"heap_merge: the k-way kernel merges 1 to "
                         f"{tile // 2} runs, not {n_runs}")
    step = 1 << ((tile // (2 * n_runs)).bit_length() - 1)

    def fits(step):
        return 8 * n_runs * _pitch(-(-cap // step)) <= KWAY_SAMPLE_BYTES
    while not fits(step) and tile // (2 * step) > n_runs:
        step *= 2
    group = tile // step - n_runs
    samples = n_runs * -(-cap // step)
    return tile, step, group, -(-samples // group), fits(step)


def kway_merge_plain(k, w, s, ix, n_runs: int):
    """Plain PyTorch version of the k-way merge of `n_runs` runs laid back
    to back (in each row of a leading batch dimension): one stable sort
    of the (key, seq) composite over the runs taken last run first — the
    tournament's order, where ties go to the higher run and then to the
    lower position."""
    lead = k.shape[:-1]
    rev = [a.reshape(*lead, n_runs, -1).flip(-2).reshape(*lead, -1)
           for a in (k, w, s, ix)]
    order = torch.sort(RU.composite(rev[0], rev[2]), dim=-1,
                       stable=True).indices
    return tuple(a.gather(-1, order) for a in rev)


def kway_merge(k, w, s, ix, n_runs: int):
    """Merge `n_runs` (key, seq)-sorted runs of equal length laid back to
    back in four (N,) int32 lanes -> the four merged lanes, in two
    launches on the card whatever the lanes (up to 1,024 runs). Lanes
    (B, N) are B independent merges of one shape — the reference's
    kernel under `jax.vmap` — in the same two launches."""
    if k.device.type == "cpu":
        return kway_merge_plain(k, w, s, ix, n_runs)
    dev = k.device
    lanes = (k, w, s, ix)
    if dev.type != "cuda" or any(a.device != dev for a in lanes):
        raise ValueError("heap_merge: lanes must share one CUDA device "
                         "(or all lie on the CPU)")
    if any(a.dtype != torch.int32 or a.dim() not in (1, 2)
           or not a.is_contiguous() or a.shape != k.shape for a in lanes):
        raise ValueError("heap_merge: four contiguous (N,) or (B, N) int32 "
                         "lanes expected")
    batch = k.shape[0] if k.dim() == 2 else 1
    n_lanes = k.shape[-1]
    if n_runs < 1 or n_lanes % n_runs:
        raise ValueError(f"heap_merge: {n_lanes} lanes are not "
                         f"{n_runs} runs of one length")
    if not 1 <= batch <= 65535:
        raise ValueError(f"heap_merge: 1 to 65,535 merges a launch, not "
                         f"{batch}")
    cap = n_lanes // n_runs
    tile, step, group, tiles, shared = kway_geometry(n_runs, cap)
    split = torch.empty(batch * tiles * n_runs, dtype=torch.int32,
                        device=dev)
    who = torch.empty(batch * tiles, dtype=torch.int32, device=dev)
    outs = tuple(torch.empty_like(a) for a in lanes)
    samples = n_runs * -(-cap // step)
    ctas = (min(132, -(-samples // KWAY_SPLIT_SAMPLES)) if shared
            else min(SPLIT_CTAS, -(-samples // 32)))
    fn = _build.bind("heap_merge", "heap_merge_kway_launch", 10, 8)
    _build.check(fn(*(a.data_ptr() for a in lanes), split.data_ptr(),
                    who.data_ptr(), *(o.data_ptr() for o in outs), n_runs,
                    cap, step, group, tile, ctas, int(shared), batch,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "heap_merge")
    kway_merge.launches += 2          # the split and the merge kernel
    return outs


kway_merge.launches = 0


def tournament(k, w, s, ix, cap: int, n_runs: int, round_fn=None):
    """log2(n_runs) rounds of `round_fn` (default `merge_round`) over runs
    of `cap` lanes laid back to back; returns the merged (key,
    seq)-sorted lanes."""
    round_fn = round_fn or merge_round
    bounds = [i * cap for i in range(n_runs + 1)]
    while len(bounds) > 2:
        k, w, s, ix = round_fn(k, w, s, ix, round_pairs(bounds))
        bounds = bounds[::2] if len(bounds) % 2 else bounds[::2] + bounds[-1:]
    return k, w, s, ix


def heap_merge(keys2d, vals2d, wts2d, seqs2d, drop_annihilated: bool):
    """Merge k sorted runs (k, cap) -> compacted run (k*cap,), newest
    wins. Returns (keys, vals, wts, seqs, count). A leading batch
    dimension — (B, k, cap) -> (B, k*cap) lanes and counts (B,) — merges
    B stacks of runs in one `kway_merge` call (the sharded engine's
    masked step)."""
    lead = keys2d.shape[:-2]
    n_runs, cap = keys2d.shape[-2:]
    total = n_runs * cap
    if total >= 2 ** 31:
        raise ValueError(f"heap_merge: {total} lanes exceed int32 indices")

    def flat(a):
        return a.reshape(*lead, total).contiguous()

    ix = torch.arange(total, dtype=torch.int32, device=keys2d.device)
    ix = ix.expand(*lead, total).contiguous()
    mk, mw, ms, mi = kway_merge(flat(keys2d), flat(wts2d), flat(seqs2d), ix,
                                n_runs)
    valid = RU.survivor_mask(mk, mw, drop_annihilated)
    order = RU.partition_order(valid)
    ok = valid.gather(-1, order)
    out_k = torch.where(ok, mk.gather(-1, order), _KEY_EMPTY)
    out_w = torch.where(ok, mw.gather(-1, order), 0)
    out_s = torch.where(ok, ms.gather(-1, order), 0)
    # payload gather — survivors only (annihilated rows never touch vals)
    src = mi.gather(-1, order).long()
    out_v = torch.where(ok, flat(vals2d).gather(-1, src), 0)
    return out_k, out_v, out_w, out_s, valid.sum(dim=-1).to(torch.int32)


def work(lanes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one merge of `lanes` lanes: every 16-byte record
    (key, value, weight, sequence) read once and written once. Integer
    work: 0 FLOPs."""
    return 0.0, float(lanes * 16 * 2)
