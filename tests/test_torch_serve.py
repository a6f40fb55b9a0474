"""The port's serving layer (`repro_torch.serve`) against the reference's
(`repro.serve`), on the CPU: the reference's serving tests
(`tests/test_serving.py`) and role tests
(`tests/replication/test_serve_roles.py`) on the port, each compared with
the reference where it computes the same thing.

- `coalesce`: the same ticket stream gives chunks (arrays, dtypes) and
  `Placement`s bitwise the reference's — hazard ordering, deletes merged
  with inserts, capacity splits, a randomized stream.
- `Server`: one request stream with forced pumps through the port's and
  the reference's server, coalesced and ``per_request``, single tree and 2
  shards: every ticket's result equal across packages and to the
  sequential engine calls and `DictOracle`, the counters equal, and the
  trees equal after `drain`.
- `WindowPolicy` and `Governor` make the reference's decisions under the
  same injected clock and backlog; submit validation raises where the
  reference's does; `closed_loop` and `AsyncServer` work.
- Roles: a follower server rejects writes, read-your-writes and shipping
  on a leader, quorum release, and held writes fail with `QuorumAckError`
  instead of hanging, sync and async."""
import asyncio
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.oracle import DictOracle  # noqa: E402
from repro_torch.core.params import KEY_EMPTY, SLSMParams  # noqa: E402
from repro_torch.engine import SLSM, ShardedSLSM  # noqa: E402
from repro_torch.engine import replication as R  # noqa: E402
from repro_torch.engine import tape as TP  # noqa: E402
from repro_torch.engine import wal as WAL  # noqa: E402
from repro_torch.serve import (AsyncServer, Governor,  # noqa: E402
                               QuorumAckError, Request, Server,
                               WindowPolicy, closed_loop, coalesce, scatter,
                               sustained_at_slo)
from test_torch_wal import (assert_same_answers,  # noqa: E402
                            probe_answers, small_params)

# the reference serving tests' geometry (max_levels 4: the per_request
# baseline and the governor push the stream through real compactions)
SMALL = dict(R=2, Rn=8, eps=0.02, D=2, m=1.0, mu=4, max_levels=4,
             max_range=64)


def params(**over) -> SLSMParams:
    return SLSMParams(**{**SMALL, **over})


def ref_params(p):
    from repro.core.params import SLSMParams as RefParams
    from repro.core.params import TuningPolicy as RefTuning
    return RefParams(**{**dataclasses.asdict(p),
                        "tuning": RefTuning(**dataclasses.asdict(p.tuning))})


def stream(seed, n_requests=36, key_space=400):
    """The reference tests' request stream: an insert-only warm-up, then
    inserts, deletes, lookups (a third guaranteed misses, `key | 1`) and
    range scans."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        kind = ("insert" if i < 4 else
                rng.choice(["insert", "insert", "lookup", "lookup",
                            "delete", "range"]))
        if kind == "insert":
            n = int(rng.integers(1, 7))
            ks = (rng.integers(0, key_space // 2, n) * 2).astype(np.int32)
            reqs.append(("insert", ks, rng.integers(-50, 50, n).astype(
                np.int32)))
        elif kind == "delete":
            ks = (rng.integers(0, key_space // 2,
                               int(rng.integers(1, 4))) * 2).astype(np.int32)
            reqs.append(("delete", ks, None))
        elif kind == "lookup":
            n = int(rng.integers(1, 7))
            ks = (rng.integers(0, key_space // 2, n) * 2).astype(np.int32)
            ks = np.where(rng.random(n) < 0.3, ks | 1, ks).astype(np.int32)
            reqs.append(("lookup", ks, None))
        else:
            n = int(rng.integers(1, 3))
            lo = rng.integers(0, key_space, n).astype(np.int32)
            hi = (lo + rng.integers(1, 48, n)).astype(np.int32)
            reqs.append(("range", lo, hi))
    return reqs


def ticket(kind, keys, vals=None):
    keys = np.asarray(keys, np.int32)
    vals = np.zeros_like(keys) if vals is None else np.asarray(vals,
                                                               np.int32)
    return SimpleNamespace(kind=kind, keys=keys, vals=vals)


def same_result(got, want, msg=""):
    if want is None:
        assert got is None, msg
        return
    assert len(got) == len(want), msg
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=msg)


# --------------------------------------------------------------------------
# the coalescer
# --------------------------------------------------------------------------

def _ticket_streams():
    rnd = [ticket(k, a, b) for k, a, b in stream(seed=13, n_requests=48)]
    big = np.arange(1, 22, dtype=np.int32) * 2
    return {
        "hazard": [ticket("lookup", [2, 4]), ticket("insert", [6], [1]),
                   ticket("lookup", [6]), ticket("lookup", [8])],
        "deletes": [ticket("insert", [2, 4], [7, 8]), ticket("delete", [6])],
        "split": [ticket("insert", big, np.arange(21)),
                  ticket("lookup", big), ticket("range", np.arange(9),
                                                np.arange(9) + 5)],
        "random": rnd,
    }


@pytest.mark.parametrize("name", list(_ticket_streams()))
def test_coalesce_is_the_reference_bitwise(name):
    """Chunks (kind, keys, vals, wts with their dtypes) and placements
    equal the reference's; scatter routes the same results back."""
    from repro.serve import coalesce as ref_coalesce
    from repro.serve import scatter as ref_scatter
    p = params()
    tickets = _ticket_streams()[name]
    chunks, places = coalesce(p, tickets)
    rchunks, rplaces = ref_coalesce(ref_params(p), tickets)
    assert places == rplaces
    assert len(chunks) == len(rchunks)
    for c, r in zip(chunks, rchunks):
        assert c.kind == r.kind
        for a, b in ((c.keys, r.keys), (c.vals, r.vals)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert (c.wts is None) == (r.wts is None)
        if c.wts is not None:
            assert c.wts.dtype == r.wts.dtype
            np.testing.assert_array_equal(c.wts, r.wts)
        assert len(c.keys) <= TP.chunk_capacity(p, c.kind)
    if name == "hazard":
        assert [c.kind for c in chunks] == ["lookup", "write", "lookup"]
    if name == "deletes":
        np.testing.assert_array_equal(chunks[0].wts, [1, 1, -1])
    if name == "split":
        assert [pl.off for pl in places[0]] == [0, 8, 16]
    # results in the tape's per-chunk form, routed by both scatters
    results = []
    for c in chunks:
        n = len(c.keys)
        if c.kind == "write":
            results.append(1)
        elif c.kind == "lookup":
            results.append((c.keys * 3, c.keys % 2 == 0))
        else:
            results.append((np.tile(c.keys[:, None], (1, 4)),
                            np.tile(c.vals[:, None], (1, 4)),
                            np.arange(n, dtype=np.int32),
                            np.zeros(n, bool)))
    got = [SimpleNamespace(**vars(t)) for t in tickets]
    want = [SimpleNamespace(**vars(t)) for t in tickets]
    scatter(got, places, results)
    ref_scatter(want, rplaces, results)
    for g, w in zip(got, want):
        same_result(g.result, w.result)


# --------------------------------------------------------------------------
# the server against the reference's, ticket for ticket
# --------------------------------------------------------------------------

def sequential(tree, reqs):
    """The oracle: one engine call a request, in submission order."""
    out = []
    for kind, a, b in reqs:
        if kind == "insert":
            tree.insert(a, b)
            out.append(None)
        elif kind == "delete":
            tree.delete(a)
            out.append(None)
        elif kind == "lookup":
            out.append(tree.lookup_many(a))
        else:
            out.append(tree.range_many(np.stack([a, b], axis=1)))
    return out


def serve(srv, reqs):
    """Every request through `srv`, forced pumps after every 7th."""
    tickets = []
    for i, (kind, a, b) in enumerate(reqs):
        tickets.append(srv.submit(f"client-{i % 3}", kind, a, b))
        if i % 7 == 6:
            srv.pump(force=True)
    srv.drain()
    return tickets


SERVE_CELLS = [("coalesced", False), ("coalesced", True),
               ("per_request", False), ("per_request", True)]


@pytest.mark.parametrize("mode,sharded", SERVE_CELLS,
                         ids=[f"{m}-{'sharded' if s else 'single'}"
                              for m, s in SERVE_CELLS])
def test_server_matches_the_reference_ticket_for_ticket(mode, sharded):
    """Each ticket's result equals the reference server's, the port's
    own sequential engine calls and `DictOracle`; the counters equal the
    reference's; after `drain` both trees answer alike."""
    from repro.engine import SLSM as RefSLSM
    from repro.engine import ShardedSLSM as RefSharded
    from repro.serve import Server as RefServer
    from repro.serve import WindowPolicy as RefWindow
    p = params()
    reqs = stream(seed=7 if mode == "coalesced" else 11)

    def port_tree():
        return (ShardedSLSM(p, n_shards=2, device="cpu") if sharded
                else SLSM(p, device="cpu"))

    rp = ref_params(p)
    ref_tree = RefSharded(rp, n_shards=2) if sharded else RefSLSM(rp)
    srv = Server(port_tree(), window=WindowPolicy(max_ops=24), mode=mode)
    ref = RefServer(ref_tree, window=RefWindow(max_ops=24), mode=mode)
    got, want = serve(srv, reqs), serve(ref, reqs)
    seq_tree = port_tree()
    seq = sequential(seq_tree, reqs)
    oracle = DictOracle()
    for i, ((kind, a, b), g, w, s) in enumerate(zip(reqs, got, want, seq)):
        assert g.done and g.error is None
        same_result(g.result, w.result, f"request {i} ({kind})")
        same_result(g.result, s, f"request {i} ({kind}) sequential")
        if kind == "insert":
            oracle.insert(a, b)
        elif kind == "delete":
            oracle.delete(a)
        elif kind == "lookup":
            v, f = oracle.lookup(a)
            np.testing.assert_array_equal(g.result[1], f)
            np.testing.assert_array_equal(g.result[0][f], v[f])
        else:
            for j, (lo, hi) in enumerate(zip(a, b)):
                ek, ev = oracle.range(int(lo), int(hi))
                c = int(g.result[2][j])
                assert c == len(ek)
                np.testing.assert_array_equal(g.result[0][j, :c], ek)
                np.testing.assert_array_equal(g.result[1][j, :c], ev)
    assert dict(srv.counters) == dict(ref.counters)
    if mode == "coalesced":
        assert srv.counters["dispatches"] < srv.counters["requests"]
    else:
        assert srv.counters["dispatches"] >= srv.counters["requests"]
    probe = np.arange(0, 400, 2, dtype=np.int32)
    for tree in (srv.tree, seq_tree):
        tree.drain()
        same_result(tree.lookup_many(probe), ref_tree.lookup_many(probe))
        same_result(tree.range_many([(0, 400), (37, 203)]),
                    ref_tree.range_many([(0, 400), (37, 203)]))


# --------------------------------------------------------------------------
# window policy, governor, validation, load generator, asyncio
# --------------------------------------------------------------------------

def test_window_policy_decides_as_the_reference():
    """Under the same occupancies and ages, the same closes and the same
    adaptive deadline, step for step, to the float."""
    from repro.serve import WindowPolicy as RefWindow
    rng = np.random.default_rng(3)
    mine, ref = WindowPolicy(max_ops=16), RefWindow(max_ops=16)
    for _ in range(300):
        n, age = int(rng.integers(0, 40)), float(rng.random() * 6e-3)
        assert mine.should_close(n, age) == ref.should_close(n, age)
        mine.closed(n)
        ref.closed(n)
        assert mine.wait_s == ref.wait_s
    wp = WindowPolicy(max_ops=16, wait_s=1e-3)
    assert wp.should_close(16, 0.0) and not wp.should_close(1, 0.0)
    assert wp.should_close(1, 2e-3) and not wp.should_close(0, 10.0)
    for _ in range(100):
        wp.closed(0)
    assert wp.wait_s == pytest.approx(wp.min_wait_s)


class _FakeTree:
    """voluntary_steps with a bounded ready backlog."""

    def __init__(self, merge_budget=1, Rn=8, ready=100):
        self.p_active = SimpleNamespace(merge_budget=merge_budget, Rn=Rn)
        self.ready = ready

    def voluntary_steps(self, budget):
        ran = min(budget, self.ready)
        self.ready -= ran
        return ran


def test_governor_decides_as_the_reference():
    """The same windows and idle gaps over the same backlog: the same
    steps run and credits banked, to the float; credit cap and idle
    allowance as the reference's tests pin them."""
    from repro.serve import Governor as RefGovernor
    rng = np.random.default_rng(4)
    for cap in (4.0, 16.0):
        mine, ref = Governor(credit_cap=cap), RefGovernor(credit_cap=cap)
        ta, tb = _FakeTree(ready=60), _FakeTree(ready=60)
        for _ in range(200):
            w = int(rng.integers(0, 40))
            if rng.random() < 0.2:
                assert mine.idle(ta) == ref.idle(tb)
            else:
                assert mine.window_done(ta, w) == ref.window_done(tb, w)
            assert mine.credits == ref.credits
            assert (mine.steps_run, mine.idle_steps_run) == (
                ref.steps_run, ref.idle_steps_run)
    gov = Governor(credit_cap=4.0)
    gov.window_done(_FakeTree(ready=0), 10_000)
    assert gov.credits == pytest.approx(4.0)
    busy = _FakeTree(ready=100)
    assert gov.window_done(busy, 0) == 4 and gov.idle(busy) == 1


def test_server_poll_under_an_injected_clock_matches_the_reference():
    """A server's window closes by size or by its oldest request's age
    on the injected clock, where the reference's does."""
    from repro.engine import SLSM as RefSLSM
    from repro.serve import Server as RefServer
    from repro.serve import WindowPolicy as RefWindow
    p = params()
    now = [0.0]
    srv = Server(SLSM(p, device="cpu"), window=WindowPolicy(max_ops=12),
                 clock=lambda: now[0])
    ref = RefServer(RefSLSM(ref_params(p)), window=RefWindow(max_ops=12),
                    clock=lambda: now[0])
    served = []
    for i, (kind, a, b) in enumerate(stream(seed=5, n_requests=30)):
        now[0] += 2e-4 * (i % 5)
        for s in (srv, ref):
            s.submit("c", kind, a, b)
        assert srv.poll() == ref.poll()
        served.append((srv.pump(), ref.pump()))
        assert srv.window.wait_s == ref.window.wait_s
    assert all(a == b for a, b in served) and any(a for a, _ in served)


def test_submit_validates_as_the_reference():
    """Unknown kinds, the reserved key, and shape mismatches raise at
    intake in both packages, with nothing queued; INT32_MIN is a legal
    payload."""
    from repro.engine import SLSM as RefSLSM
    from repro.serve import Server as RefServer
    p = params()
    srv = Server(SLSM(p, device="cpu"))
    ref = RefServer(RefSLSM(ref_params(p)))
    bad = [("upsert", [2], None), ("insert", [2, KEY_EMPTY], [1, 2]),
           ("insert", [2, 4], [1]), ("lookup", [KEY_EMPTY], None),
           ("delete", [KEY_EMPTY], None), ("range", [1, 2], [3])]
    for kind, keys, vals in bad:
        with pytest.raises(ValueError) as mine:
            srv.submit("c", kind, keys, vals)
        with pytest.raises(ValueError) as theirs:
            ref.submit("c", kind, keys, vals)
        assert str(mine.value) == str(theirs.value)
    assert srv.pending == 0
    srv.submit("c", "insert", [2], [np.iinfo(np.int32).min])
    assert srv.pending == 1


def test_closed_loop_and_stats():
    """The closed loop serves a stream of `Request`s at 4 clients; the
    latency ledgers and counters add up, and the SLO helper picks it."""
    reqs = [Request(k, a, b) for k, a, b in stream(seed=5, n_requests=30)]
    srv = Server(SLSM(params(), device="cpu"))
    srv.warm(full=False)
    pt = closed_loop(srv, reqs, concurrency=4)
    assert pt["clients"] == 4 and pt["requests"] == 30
    assert pt["ops"] == sum(r.keys.size for r in reqs)
    assert pt["max_stall_us"] >= pt["p999_us"] >= pt["p99_us"] > 0
    assert pt["dispatches"] <= pt["windows"] + 1
    srv.drain()
    st = srv.stats()
    assert set(st["clients"]) == {f"client-{c}" for c in range(4)}
    assert st["counters"]["requests"] == 30 and st["role"] == "leader"
    assert sustained_at_slo([pt], slo_p99_us=pt["p99_us"]) == pt["ops_per_s"]
    assert sustained_at_slo([pt], slo_p99_us=0.0) == 0.0
    with pytest.raises(ValueError):
        closed_loop(srv, reqs, concurrency=0)


def test_async_frontend_roundtrip():
    srv = Server(SLSM(params(), device="cpu"), window=WindowPolicy(max_ops=4))

    async def scenario():
        async with AsyncServer(srv, poll_s=1e-4) as front:
            await front.submit("a", "insert", np.int32([2, 4]),
                               np.int32([20, 40]))
            return await front.submit("a", "lookup", np.int32([2, 4, 5]))

    vals, found = asyncio.run(scenario())
    np.testing.assert_array_equal(found, [True, True, False])
    np.testing.assert_array_equal(vals[:2], [20, 40])


# --------------------------------------------------------------------------
# replication roles
# --------------------------------------------------------------------------

def durable_leader(tmp_path, **leader_kw):
    p = small_params()
    dur = WAL.Durability(tmp_path / "leader", fsync=False,
                         snapshot_every_bytes=1 << 30)
    drv = SLSM(p, device="cpu", durability=dur)
    return drv, R.Leader(drv, **leader_kw)


def quorum_server(tmp_path, quorum_timeout_s=30.0, clock=None):
    kw = {} if clock is None else {"clock": clock}
    drv, leader = durable_leader(tmp_path, ack_mode="quorum", quorum=1, **kw)
    fol = leader.add_follower(tmp_path / "fol")
    return drv, leader, fol, Server(drv, role="leader",
                                    quorum_timeout_s=quorum_timeout_s, **kw)


def test_follower_server_rejects_writes(tmp_path):
    drv, leader = durable_leader(tmp_path)
    drv.insert(np.arange(0, 60, 3, dtype=np.int32),
               np.arange(20, dtype=np.int32))
    fol = leader.add_follower(tmp_path / "fol")
    R.converge(leader, fol)
    srv = Server(fol.drv, role="follower")
    for kind, vals in (("insert", np.int32([1])), ("delete", None)):
        with pytest.raises(ValueError, match="read-only"):
            srv.submit("c", kind, np.int32([2]), vals)
    assert srv.pending == 0
    probe = np.int32([0, 3, 6, 9, 10])
    t = srv.submit("c", "lookup", probe)
    srv.pump(force=True)
    same_result(t.result, fol.drv.lookup_many(probe))
    assert t.result[1].tolist() == [True, True, True, True, False]
    st = srv.stats()
    assert st["role"] == "follower" and st["replication"]["role"] == "follower"
    assert AsyncServer(srv).role == "follower"
    with pytest.raises(ValueError):
        Server(fol.drv, role="observer")


def test_leader_server_read_your_writes_and_ships(tmp_path):
    drv, leader = durable_leader(tmp_path)
    fol = leader.add_follower(tmp_path / "fol")
    srv = Server(drv, role="leader", window=WindowPolicy(max_ops=64))
    fsrv = Server(fol.drv, role="follower")
    keys = np.int32([10, 20, 30])
    srv.submit("w", "insert", keys, keys * 3)
    t = srv.submit("w", "lookup", keys)
    srv.pump(force=True)
    assert t.result[1].all() and (t.result[0] == keys * 3).all()
    st = srv.stats()
    assert st["replication"]["followers"] == 1
    assert st["replication"]["shipped_records"] >= 1
    fsrv.pump()                         # idle gap: apply the stream
    r = fsrv.submit("r", "lookup", keys)
    fsrv.pump(force=True)
    assert r.result[1].all() and (r.result[0] == keys * 3).all()
    assert fsrv.stats()["replication"]["applied_records"] >= 1
    for _ in range(4):
        srv.pump()
        fol.pump()
    assert leader.stats()["follower_lag_records"] == 0
    assert_same_answers(probe_answers(fol.drv), probe_answers(drv))


def test_quorum_release(tmp_path):
    drv, leader, fol, srv = quorum_server(tmp_path)
    t = srv.submit("w", "insert", np.int32([1, 2]), np.int32([10, 20]))
    srv.pump(force=True)
    assert not t.done and srv.stats()["unacked_writes"] == 1
    fol.pump()                          # apply + ack
    srv.pump()                          # drain, advertise, release
    assert t.done and t.error is None
    assert srv.counters["quorum_releases"] == 1
    assert srv.stats()["unacked_windows"] == 0


def test_quorum_held_writes_fail_instead_of_hanging(tmp_path):
    """Drain, a quorum unreachable past the timeout, and deposition each
    fail the held tickets with `QuorumAckError`."""
    now = [0.0]
    drv, leader, fol, srv = quorum_server(tmp_path, quorum_timeout_s=5.0,
                                          clock=lambda: now[0])
    ta = srv.submit("w", "insert", np.int32([1]), np.int32([10]))
    srv.pump(force=True)
    srv.drain()
    assert ta.done and isinstance(ta.error, QuorumAckError)
    tb = srv.submit("w", "insert", np.int32([2]), np.int32([20]))
    srv.pump(force=True)
    now[0] += 10.0
    srv.pump()
    assert tb.done and isinstance(tb.error, QuorumAckError)
    tc = srv.submit("w", "insert", np.int32([3]), np.int32([30]))
    srv.pump(force=True)
    leader.deposed = True
    drv.demote()
    srv.pump()
    assert tc.done and isinstance(tc.error, QuorumAckError)
    assert srv.counters["quorum_failed"] == 3
    assert srv.stats()["role"] == "follower"


def test_async_quorum_fail_raises_not_hangs(tmp_path):
    drv, leader, fol, srv = quorum_server(tmp_path, quorum_timeout_s=0.2)

    async def run():
        async with AsyncServer(srv) as asrv:
            with pytest.raises(QuorumAckError):
                await asrv.submit("w", "insert", np.int32([5]),
                                  np.int32([50]))

    asyncio.run(run())
    assert srv.counters["quorum_failed"] >= 1
