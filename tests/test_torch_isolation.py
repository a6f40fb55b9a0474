"""The port stands alone: importing every `repro_torch` module pulls in
neither JAX nor the reference package, and the engine refuses to start
without a CUDA card unless asked for the CPU, adaptive tuning or not."""
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
for name in mods:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(mods), "modules;", "leaked:", bad)
assert len(mods) >= 20, mods
assert not bad, bad
import torch
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
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "leaked: []" in out.stdout
