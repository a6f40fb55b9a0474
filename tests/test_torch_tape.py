"""Port parity of the mixed-op tape: `run_tape` against the reference's
`run_tape` (per-chunk results, seals and every state leaf, bitwise,
windows that segment included) and against the port's own ops one by
one, on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.oracle import DictOracle  # noqa: E402
from repro.core.params import SLSMParams, TuningPolicy  # noqa: E402
from repro.engine import SLSM as RefSLSM  # noqa: E402
from repro.engine import tape as RTP  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.engine import SLSM  # noqa: E402
from repro_torch.engine import tape as TP  # noqa: E402

SMALL = dict(R=2, Rn=8, eps=0.02, D=2, m=1.0, mu=4, max_levels=3,
             max_range=512, cand_factor=16)
KEY_SPACE = 100
COUNTERS = ("seals", "flushes", "spills", "compactions", "retunes",
            "rows_merged_in", "rows_merged_out", "rows_annihilated",
            "writes", "reads")


def _leaves_equal(ref_state, port_state):
    want = jax.tree_util.tree_leaves(ref_state)
    got = convert.state_to_leaves(port_state)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == w.dtype, f"leaf {i}"
        np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")


def _window(rng, rn: int, rb: int, n_chunks: int, big: bool):
    """A stream-ordered window: writes (a tenth deletes), lookups and
    ranges, half, two fifths and a tenth of the chunks."""
    out = []
    for _ in range(n_chunks):
        u = rng.random()
        if u < 0.5:
            n = int(rng.integers(rn // 2 if big else 1, rn + 1))
            ks = rng.integers(0, KEY_SPACE, n).astype(np.int32)
            ws = np.where(rng.random(n) < 0.1, -1, 1).astype(np.int32)
            vs = np.where(ws > 0, rng.integers(-99, 99, n), 0).astype(np.int32)
            out.append(("write", ks, vs, ws))
        elif u < 0.9:
            n = int(rng.integers(1, rn + 1))
            out.append(("lookup", rng.integers(-4, KEY_SPACE + 4, n)
                        .astype(np.int32), np.zeros(n, np.int32), None))
        else:
            n = int(rng.integers(1, rb + 1))
            lo = rng.integers(-4, KEY_SPACE, n).astype(np.int32)
            out.append(("range", lo, (lo + rng.integers(0, 60, n))
                        .astype(np.int32), None))
    return out


def _results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, int):
            assert g == w
        else:
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, np.asarray(b))


def _check_oracle(window, results, oracle):
    """Replay the window into the dict oracle; each read equals it."""
    for (kind, ks, vs, ws), res in zip(window, results):
        if kind == "write":
            ins = ws > 0
            for k, v, w in zip(ks, vs, ins):
                if w:
                    oracle.insert(np.asarray([k]), np.asarray([v]))
                else:
                    oracle.delete(np.asarray([k]))
        elif kind == "lookup":
            vo, fo = oracle.lookup(ks)
            np.testing.assert_array_equal(res[1], fo)
            np.testing.assert_array_equal(res[0][res[1]], vo[fo])
        else:
            for i, (lo, hi) in enumerate(zip(ks, vs)):
                ok, ov = oracle.range(int(lo), int(hi))
                assert not res[3][i] and res[2][i] == len(ok)
                np.testing.assert_array_equal(res[0][i, :res[2][i]], ok)
                np.testing.assert_array_equal(res[1][i, :res[2][i]], ov)


@pytest.mark.parametrize("mode", ["static", "adaptive"])
@pytest.mark.parametrize("sparse", [False, True])
def test_run_tape_bitwise_against_reference(mode, sparse):
    """Per-chunk results, seals, counters and state leaves after every
    window; the windows of big writes exceed `tape_write_capacity` and
    segment."""
    tuning = TuningPolicy(mode=mode, interval=64, eps_floor=1e-3)
    ref_p = SLSMParams(**SMALL, merge_budget=1, tuning=tuning)
    ref = RefSLSM(ref_p)
    port = SLSM(convert.params_from_dict(dataclasses.asdict(ref_p)),
                device="cpu")
    oracle = DictOracle()
    rng = np.random.default_rng(7 + sparse + 2 * (mode == "adaptive"))
    rb = TP.range_lanes(port.p)
    segmented = 0
    for w in range(14):
        window = _window(rng, port.p.Rn, rb, int(rng.integers(4, 17)),
                         big=w % 3 == 1)
        writes = sum(len(c[1]) for c in window if c[0] == "write")
        segmented += writes > port.tape_write_capacity()
        assert port.tape_write_capacity() == ref.tape_write_capacity()
        want = ref.run_tape([RTP.TapeChunk(*c) for c in window], sparse)
        got = port.run_tape([TP.TapeChunk(*c) for c in window], sparse)
        _results_equal(got, want)
        _check_oracle(window, got, oracle)
        _leaves_equal(ref.state, port.state)
        for name in COUNTERS:
            assert port.stats[name] == ref.stats[name], name
        assert port.tuner.read_frac == ref.tuner.read_frac
        assert port.voluntary_steps(1) == ref.voluntary_steps(1)
        _leaves_equal(ref.state, port.state)
    assert segmented >= 2 and port.stats["seals"] > 0
    assert port.n_levels >= 1


def test_run_tape_equals_the_ops_one_by_one():
    """The same windows through `run_tape` on one engine and through
    insert/delete/lookup_many/range_many on another: equal answers."""
    p = convert.params_from_dict(dataclasses.asdict(
        SLSMParams(**SMALL, merge_budget=1)))
    tape, ops = SLSM(p, device="cpu"), SLSM(p, device="cpu")
    rng = np.random.default_rng(21)
    for w in range(12):
        window = _window(rng, p.Rn, TP.range_lanes(p),
                         int(rng.integers(4, 17)), big=w % 4 == 0)
        got = tape.run_tape(window)
        for (kind, ks, vs, ws), res in zip(window, got):
            if kind == "write":
                for i in range(len(ks)):     # weights keep stream order
                    if ws[i] > 0:
                        ops.insert(ks[i:i + 1], vs[i:i + 1])
                    else:
                        ops.delete(ks[i:i + 1])
            elif kind == "lookup":
                for a, b in zip(res, ops.lookup_many(ks)):
                    np.testing.assert_array_equal(a, b)
            else:
                for a, b in zip(res, ops.range_many(np.stack([ks, vs], 1))):
                    np.testing.assert_array_equal(a, b)
        tape.voluntary_steps(1)
    assert tape.stats["writes"] == ops.stats["writes"]


def test_build_tape_and_seal_bound_match_reference():
    ref_p = SLSMParams(**SMALL)
    p = convert.params_from_dict(dataclasses.asdict(ref_p))
    window = _window(np.random.default_rng(3), p.Rn, TP.range_lanes(p), 11,
                     big=True)
    want = RTP.build_tape(ref_p, [RTP.TapeChunk(*c) for c in window])
    got = TP.build_tape(p, [TP.TapeChunk(*c) for c in window])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for stage in (0, 3, 7):
        assert TP.tape_seal_bound(p, stage, [TP.TapeChunk(*c)
                                             for c in window]) == \
            RTP.tape_seal_bound(ref_p, stage, [RTP.TapeChunk(*c)
                                               for c in window])
    assert (TP.chunk_capacity(p, "range"), TP.chunk_capacity(p, "write")) \
        == (RTP.chunk_capacity(ref_p, "range"),
            RTP.chunk_capacity(ref_p, "write"))
    with pytest.raises(ValueError, match="capacity"):
        TP.build_tape(p, [TP.TapeChunk("lookup", np.zeros(p.Rn + 1),
                                       np.zeros(p.Rn + 1))])


def test_bucket_grids_match_reference():
    from repro.engine import batching as RB
    from repro_torch.engine import batching as TB
    for n in list(range(1, 300)) + [1023, 1024, 1025, 4095, 4096, 4097,
                                     9000]:
        assert TB.adaptive_bucket(n) == RB.adaptive_bucket(n)
        assert TB.tape_bucket(n) == RB.tape_bucket(n)
        assert TB.range_bucket(n) == RB.range_bucket(n)
        assert TB.bucket_pow2(n) == RB.bucket_pow2(n)
