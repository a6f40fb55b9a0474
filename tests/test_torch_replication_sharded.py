"""The same-stream parity of `test_torch_replication.py` on the sharded
engine (2 shards, static and adaptive): the reference's and the port's
`Leader` with two `Follower`s write the same follower `wal.log` bytes,
report equal `Leader.stats()`, `Follower.stats()` and ``counters``, and
answer bitwise alike and as `DictOracle`. A file of its own so that each
file stays short on one test worker."""
import pytest

pytest.importorskip("torch")

from test_torch_replication import (cell_ids, cell_runs,  # noqa: E402
                                    check_answers,
                                    check_bytes_stats_and_counters)

CELLS = [("sharded", False), ("sharded", True)]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    return cell_runs(tmp_path_factory)


@pytest.mark.parametrize("cell", CELLS, ids=cell_ids(CELLS))
def test_same_stream_same_bytes_stats_and_counters(cells, cell):
    check_bytes_stats_and_counters(cells(cell))


@pytest.mark.parametrize("cell", CELLS, ids=cell_ids(CELLS))
def test_same_stream_same_answers(cells, cell):
    check_answers(cells(cell))
