"""The paper's workload families and the named scenarios (port of
`repro.bench`'s `workloads` and `scenarios`).

  workloads.py — seeded key-distribution generators (uniform, sequential,
                 zipfian-skewed, delete-heavy, range-scan, shifting,
                 serving), numpy streams byte-identical to the
                 reference's.
  scenarios.py — named scenarios + one-knob sweeps over the paper's
                 parameters, on the port's `SLSMParams`.

The reference's `runner` and `schema` come with the port's benchmark.
"""
from repro_torch.bench.scenarios import (ADAPTIVE, CANONICAL,  # noqa: F401
                                         PROFILES, SCENARIOS, SHIFT_PARAMS,
                                         SWEEPS, Scenario, bench_params,
                                         scenarios_for)
from repro_torch.bench.workloads import (WORKLOAD_FAMILIES,  # noqa: F401
                                         KVWorkload, ServingRequest,
                                         ServingWorkload, Workload,
                                         make_kv_workload, make_workload)
