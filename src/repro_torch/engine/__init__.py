"""The sLSM engine on PyTorch (port of `repro.engine`).

Layer map:
  backend.py    — the four kernel slots + fence/gate helpers
  batching.py   — the pad/bucket grid of the batched entry points
  memtable.py   — staging buffer (active run) + sealed memory runs
  levels.py     — disk-tier state: runs, Bloom filters, fences, min/max
  compaction.py — the Do-Merge cascade ops + tiering/leveling policies
  scheduler.py  — the cascade as paced, bounded MergeSteps (merge_budget)
  tuner.py      — the adaptive allocation controller and its RETUNE rebuild
  tape.py       — the mixed-op tape (coalesced write/lookup/range window)
  read_path.py  — dense and sparse lookups, probe telemetry, scans, aggregates
                  (dense lookups, scans and aggregates also over a leading
                  shard dimension)
  sharded.py    — S hash-partitioned trees in one stacked state
  wal.py        — durability: the CRC-framed, sequence-numbered WAL, atomic
                  snapshots and the `Durability` manager (restore())
  replication.py— single-leader replication over the WAL, on the
                  reference's wire: `Leader` ships durable frames verbatim,
                  `Follower` replays them on its own engine and acks;
                  leases, epoch fencing, quorum acks, pruning
  engine.py     — the host-side `SLSM` engine

The public names are the reference's `repro.engine` exports but
`OpsBackend`, `get_backend` and `BACKENDS`: the port has no backend
selector (a tensor's device picks the plain version or the kernel).
"""
from repro_torch.engine.backend import lookup_level_many  # noqa: F401
from repro_torch.engine.batching import (ADAPTIVE_BUCKETS,  # noqa: F401
                                         RANGE_BUCKETS, adaptive_bucket,
                                         bucket_pow2, pad_pow2, pad_to,
                                         range_bucket, range_many_host)
from repro_torch.engine.compaction import (CompactionPolicy,  # noqa: F401
                                           LevelingPolicy, TieringPolicy,
                                           compact_last_level,
                                           merge_buffer_to_level0,
                                           merge_level_down)
from repro_torch.engine.engine import SLSM, reject_reserved  # noqa: F401
from repro_torch.engine.levels import LevelState, empty_level  # noqa: F401
from repro_torch.engine.memtable import (SLSMState, init_state,  # noqa: F401
                                         seal_run, stage_append)
from repro_torch.engine.read_path import (aggregate_many,  # noqa: F401
                                          lookup_batch, lookup_many,
                                          range_many, range_query)
from repro_torch.engine.scheduler import (MergeScheduler,  # noqa: F401
                                          MergeStep, Occupancy,
                                          backlog_cost, pending_steps,
                                          step_cost)
from repro_torch.engine.sharded import ShardedSLSM, shard_ids  # noqa: F401
from repro_torch.engine.tuner import (Allocation,  # noqa: F401
                                      ReadModePolicy, Tuner,
                                      allocation_bytes, build_presets,
                                      monkey_eps_per_level, retune_filters)
from repro_torch.engine import wal  # noqa: F401
from repro_torch.engine.wal import (Durability, SnapshotError,  # noqa: F401
                                    WalRecord, WalTailer, WalWriter,
                                    as_durability, check_frame,
                                    list_snapshots, load_latest_snapshot,
                                    read_snapshot, read_wal, record_offsets,
                                    write_snapshot)
from repro_torch.engine.replication import (Follower, Leader,  # noqa: F401,E402
                                           QueueLink, SocketListener,
                                           converge)
