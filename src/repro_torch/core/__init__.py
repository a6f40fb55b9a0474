"""sLSM core: parameters, Bloom filters, sorted-run primitives, the dict
and skiplist oracles, geometric levels, and the `slsm` facade (port of
`repro.core`).

Engine symbols (`SLSM`, `SLSMState`, ...) resolve lazily (PEP 562), as
in the reference: `repro_torch.core.slsm` is a facade over
`repro_torch.engine`, whose modules import the leaf modules here
(params, bloom, runs), so lazy resolution keeps the dependency acyclic
whichever package is imported first.
"""
from repro_torch.core.params import (KEY_EMPTY, SEQ_NONE,  # noqa: F401
                                     TOMBSTONE, SLSMParams, TuningPolicy)

_ENGINE_EXPORTS = ("SLSM", "ShardedSLSM", "LevelState", "SLSMState",
                   "init_state", "lookup_batch", "range_query")


def __getattr__(name: str):
    if name == "slsm":  # attribute-style submodule access after bare import
        import importlib
        return importlib.import_module("repro_torch.core.slsm")
    if name in _ENGINE_EXPORTS:
        from repro_torch.core import slsm
        return getattr(slsm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_ENGINE_EXPORTS) + ["slsm"])
