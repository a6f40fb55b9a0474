"""The port stands alone: importing every `repro_torch` module (the
training path's `train` and `data`, `distributed`, `launch` and
`bench` among them; none sets XLA_FLAGS, as the reference's dry run does) and the process-kill twins (`tools/*_torch.py`; the failover
demo twin runs at import, so its imports are read from its source, as
are the KV service twin's)
pulls in neither JAX nor the reference package (nor `ml_dtypes`: the snapshot
codec and checkpoints carry bfloat16 without it), and the engine refuses
to start without a CUDA card unless asked for the CPU, adaptive tuning
or not."""
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in mods + ["repro_torch.engine.wal", "repro_torch.checkpoint",
                    "repro_torch.train", "repro_torch.train.train_step",
                    "repro_torch.data"]:
    importlib.import_module(name)
assert {"repro_torch.train.train_step", "repro_torch.data.pipeline",
        "repro_torch.distributed.sharding", "repro_torch.distributed.runtime",
        "repro_torch.distributed.compress", "repro_torch.distributed.elastic",
        "repro_torch.distributed.pipeline", "repro_torch.launch.mesh",
        "repro_torch.launch.cost", "repro_torch.launch.dryrun",
        "repro_torch.launch.roofline", "repro_torch.launch.report",
        "repro_torch.launch.diagnose", "repro_torch.bench.workloads",
        "repro_torch.bench.scenarios"} <= set(mods), mods
import os
assert "XLA_FLAGS" not in os.environ, os.environ["XLA_FLAGS"]
import ast, importlib.util
for tool in ("recovery_smoke_torch", "replication_smoke_torch"):
    spec = importlib.util.spec_from_file_location(tool, f"tools/{tool}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
for script in ("tools/recovery_smoke_torch.py",
               "tools/replication_smoke_torch.py",
               "examples/failover_demo_torch.py",
               "examples/kv_store_service_torch.py"):
    for node in ast.walk(ast.parse(open(script).read())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "repro", "jaxlib"), (script, n)
import tempfile
import torch
from repro_torch.checkpoint import CheckpointManager
from repro_torch.engine import wal
with tempfile.TemporaryDirectory() as d:
    tree = {"w": torch.ones(3, dtype=torch.bfloat16), "n": torch.arange(2)}
    CheckpointManager(d).save(1, tree)
    got, _ = CheckpointManager(d).restore(tree, device="cpu")
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"],
                                                            tree["w"])
    wal.write_snapshot(d, 0, [tree["w"]], {})
    assert torch.equal(wal.read_snapshot(d + "/snap_0")[0][0], tree["w"])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro.") or m == "ml_dtypes"
             or m.startswith("ml_dtypes."))
print(len(mods), "modules;", "leaked:", bad)
assert len(mods) >= 20, mods
assert not bad, bad
from repro_torch.core.params import SLSMParams, TuningPolicy
from repro_torch.engine import SLSM
if not torch.cuda.is_available():
    for p in (None, SLSMParams(tuning=TuningPolicy(mode="adaptive"))):
        try:
            SLSM(p)
        except RuntimeError as e:
            assert "device='cpu'" in str(e), e
        else:
            raise AssertionError("SLSM() started without a CUDA device")
"""


def test_port_imports_neither_jax_nor_reference():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "leaked: []" in out.stdout
