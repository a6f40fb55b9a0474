"""The port's process-kill twins, each run once as a subprocess on the
CPU (`--device cpu`) at its defaults: `tools/recovery_smoke_torch.py`
(a SIGKILLed durable server, then a crash-exact restore),
`tools/replication_smoke_torch.py` (a SIGKILLed leader, then an
answer-exact promotion; `--partition`: a SIGSTOPped leader, automatic
promotion, fencing and a bitwise rejoin), `examples/failover_demo_torch.py`
and `examples/kv_store_service_torch.py` (at 20,000 requests). Each must
exit 0 and print the success line of the reference's twin.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent

TWINS = {
    "recovery": (["tools/recovery_smoke_torch.py"],
                 "OK: restore is oracle-exact at chunk boundary"),
    "replication": (["tools/replication_smoke_torch.py"],
                    "OK: failover is answer-exact at write-chunk boundary"),
    "partition": (["tools/replication_smoke_torch.py", "--partition"],
                  "OK: automatic promotion in"),
    "failover_demo": (["examples/failover_demo_torch.py"],
                      "OK: automatic failover -> fence -> rejoin, all "
                      "answer-exact"),
    "kv_store_service": (["examples/kv_store_service_torch.py",
                          "--requests", "20000"],
                         "verification: 2,000 sampled keys all correct "
                         "(newest-wins)"),
}


@pytest.mark.parametrize("twin", sorted(TWINS))
def test_twin_exits_zero_with_reference_success_line(twin):
    args, line = TWINS[twin]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, *args, "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=400)
    assert out.returncode == 0, out.stdout + out.stderr
    assert any(ln.startswith(line) for ln in out.stdout.splitlines()), (
        out.stdout)
