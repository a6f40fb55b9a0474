"""Self-healing replication demo on the PyTorch port: automatic failover,
fencing, rejoin (the twin of `examples/failover_demo.py`, over
`repro_torch`).

Run:  PYTHONPATH=src python examples/failover_demo_torch.py
      (on the CUDA card; --device cpu runs the plain PyTorch path)

The deposed-leader story (DESIGN.md §15) end to end, on an injected
fake clock so every step is deterministic — no sleeps, no flake. Every
section asserts its output, so this file doubles as a smoke test.
"""
import argparse
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.configs.slsm_paper import paper_params
from repro_torch.engine import SLSM, Durability
from repro_torch.engine import replication as R


class Clock:
    """Injectable monotonic time: the demo decides when leases expire."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def probe(drv):
    v, f = drv.lookup_many(np.arange(0, 400, dtype=np.int32))
    return np.asarray(v), np.asarray(f)


ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = ap.parse_args().device

clock = Clock()
root = Path(tempfile.mkdtemp(prefix="failover_demo_"))
params = paper_params(R=4, Rn=64, D=2, mu=32, max_levels=3)

# -- a leased cluster: one leader, two auto-promote followers ----------
leader = R.Leader(
    SLSM(params, durability=Durability(root / "leader",
                                       snapshot_every_bytes=1 << 30),
         device=device),
    lease_s=2.0, clock=clock)
rng = np.random.default_rng(7)
keys = rng.choice(400, size=300, replace=False).astype(np.int32)
leader.drv.insert(keys, keys * 3 + 1)

fols = [leader.add_follower(root / f"f{i}", auto_promote=True, clock=clock)
        for i in range(2)]
for _ in range(3):
    leader.pump()                       # ship + heartbeat (arms leases)
    for f in fols:
        f.pump()
leader.pump()                           # drain the final acks
assert all(f.lease_deadline is not None for f in fols)
print(f"cluster up: leader + {len(fols)} followers, leases armed "
      f"(lease_s={leader.lease_s}, acked seqno {fols[0].last_seqno})")

# -- the partition: heartbeats stop, the clock runs on -----------------
clock.t += 3.0 * leader.lease_s         # leader never pumps again...
for f in fols:
    f.pump()                            # ...so the lease detector fires
new_lead = fols[0].new_leader           # successor rule: best ack,
assert new_lead is not None             #   lowest id — exactly one wins
assert fols[1].new_leader is None and not fols[1].promoted
print(f"lease expired: follower 0 auto-promoted to epoch "
      f"{int(new_lead.drv.durability.writer.epoch)}; follower 1 stood down")

# -- the deposed leader doesn't know yet: it writes into the fence -----
leader.drv.insert(np.array([7, 11], np.int32), np.array([1, 2], np.int32))
leader.pump()                           # ships at the stale epoch
new_lead.pump()                         # the fence answers, epoch bumped
leader.pump()                           # ack(epoch > mine) -> depose
assert leader.deposed and leader.drv.fenced
try:
    leader.drv.insert(np.array([1], np.int32), np.array([1], np.int32))
    raise AssertionError("a fenced engine must reject writes")
except RuntimeError as e:
    assert "fenced" in str(e)
print("partition healed: old leader fenced itself on the bumped-epoch "
      "ack (writes raise, its unacked tail died with the old epoch)")

# -- rejoin: the deposed node re-enters as a bootstrapped follower -----
rejoined = new_lead.add_follower(root / "rejoined")
new_lead.drv.insert(np.arange(350, 380, dtype=np.int32),
                    np.arange(350, 380, dtype=np.int32) * 5)
R.converge(new_lead, rejoined)
(nv, nf), (rv, rf) = probe(new_lead.drv), probe(rejoined.drv)
assert np.array_equal(nv, rv) and np.array_equal(nf, rf)
print(f"rejoined: the deposed node serves reads bitwise-equal to the "
      f"new leader at seqno {rejoined.last_seqno}")

print("OK: automatic failover -> fence -> rejoin, all answer-exact")
