"""The Skiplist-Based LSM Tree: the back-compat facade over
`repro_torch.engine`, the port of `repro.core.slsm`.

It re-exports the engine's public pieces under the reference's names:
memtable (`SLSMState`, `init_state`, `stage_append`, `seal_run`),
levels (`LevelState`, `empty_level`), compaction (the policies and the
Do-Merge cascade ops), the read path (`lookup_batch`, `lookup_many`,
`range_query`) and the drivers (`SLSM`, `ShardedSLSM`).

The reference's `OpsBackend` and `get_backend` are left out: the port
has no backend selector. Each hot primitive dispatches by the device of
its tensors — a CPU tensor runs the plain PyTorch version, a CUDA tensor
launches the hand-written kernel (ROADMAP, "Dispatch by device").
"""
from repro_torch.engine.compaction import (CompactionPolicy,  # noqa: F401
                                           LevelingPolicy, TieringPolicy,
                                           compact_last_level,
                                           merge_buffer_to_level0,
                                           merge_level_down)
from repro_torch.engine.engine import SLSM  # noqa: F401
from repro_torch.engine.levels import LevelState, empty_level  # noqa: F401
from repro_torch.engine.memtable import (SLSMState, init_state,  # noqa: F401
                                         seal_run, stage_append)
from repro_torch.engine.read_path import (lookup_batch,  # noqa: F401
                                          lookup_many, range_query)
from repro_torch.engine.sharded import ShardedSLSM  # noqa: F401
