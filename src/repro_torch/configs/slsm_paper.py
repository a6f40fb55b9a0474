"""The paper's own tuned baseline (Section 3): mu=512, eps=0.001, R=50,
Rn=800, D=20, m=1.0 — the port's copy of `repro.configs.slsm_paper`."""
from repro_torch.core.params import SLSMParams, TuningPolicy  # noqa: F401

PAPER_BASELINE = SLSMParams(R=50, Rn=800, eps=1e-3, D=20, m=1.0, mu=512,
                            max_levels=3)


def paper_params(**overrides) -> SLSMParams:
    """Section 3 baseline with keyword overrides (e.g. the adaptation
    knobs ``paper_params(merge_budget=1, range_cand=512)``)."""
    base = dict(R=50, Rn=800, eps=1e-3, D=20, m=1.0, mu=512, max_levels=3)
    base.update(overrides)
    return SLSMParams(**base)
