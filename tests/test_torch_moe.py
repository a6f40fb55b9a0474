"""Port parity of the moe family: `models/moe.py` (`moe_capacity`,
`moe_ffn`), the moe block in `models/lm.py` (`forward`, `logits_full`,
parameter scales) and the converter's moe leaves, against the reference
on the same numpy inputs, at `smoke()` size in f32 (JAX on the CPU,
torch on the CPU).

Tolerances: `moe_ffn`'s y and aux rtol 1e-5 (atol 1e-6 for elements
that sum to near zero), f32 arithmetic in another order; the model's
hidden states and logits rtol = atol = 2e-3, the reference suite's own.
The whole slice (prefill, teacher-forced decode, `generate`) runs in
`tests/test_torch_lm.py`, whose architectures include the two moe ids.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import MOE_ARCHS, get_config  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

ARCHS = [a.replace("_", "-") for a in MOE_ARCHS]
FFN_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)

# (moe_dp_groups, capacity_factor): None keeps smoke()'s 4.0, where no
# expert overflows; 0.5 drops pairs (every expert's capacity times E is
# below the group's token-expert pairs)
CASES = {"no_drops": (1, None), "drops": (1, 0.5), "groups2": (2, None),
         "groups2_drops": (2, 0.5)}


def _configs(arch, **over):
    return (dataclasses.replace(get_config(arch).smoke(), **over),
            dataclasses.replace(ref_config(arch).smoke(), **over))


def _moe_from(cfg, p) -> TMOE.MoE:
    moe = TMOE.MoE(cfg, "cpu", torch.float32)
    with torch.no_grad():
        for name, a in p.items():
            getattr(moe, name).copy_(torch.from_numpy(np.array(a)))
    return moe.requires_grad_(False)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, case):
    groups, factor = CASES[case]
    over = {"moe_dp_groups": groups}
    if factor is not None:
        over["capacity_factor"] = factor
    cfg, rcfg = _configs(arch, **over)
    p = RMOE.init_moe(rcfg, jax.random.PRNGKey(11))
    x = np.random.default_rng(12).normal(size=(2, 64, cfg.d_model)).astype(
        np.float32)
    pairs = x.shape[0] * x.shape[1] // groups * cfg.moe_top_k
    cap = TMOE.moe_capacity(cfg, x.shape[0] * x.shape[1] // groups)
    assert (cap * cfg.n_experts < pairs) == (factor == 0.5)
    want_y, want_aux = RMOE.moe_ffn(rcfg, p, jnp.asarray(x))
    got_y, got_aux = TMOE.moe_ffn(cfg, _moe_from(cfg, p), torch.from_numpy(x))
    assert got_y.dtype == torch.float32 and got_y.shape == x.shape
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **FFN_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **FFN_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_capacity_matches_reference(arch):
    for base in (get_config(arch), get_config(arch).smoke()):
        for factor in (0.5, 1.0, 1.25, 4.0):
            cfg = dataclasses.replace(base, capacity_factor=factor)
            rcfg = dataclasses.replace(ref_config(arch), n_experts=cfg.n_experts,
                                       moe_top_k=cfg.moe_top_k,
                                       capacity_factor=factor)
            for tokens in (1, 2, 7, 8, 63, 100, 1024, 16_384, 49_152):
                assert (TMOE.moe_capacity(cfg, tokens)
                        == RMOE.moe_capacity(rcfg, tokens))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_converter_and_forward(arch):
    """The converter round-trips a moe tree leaf for leaf; the port's
    `forward` (hidden, aux summed over layers) and `logits_full` match
    the reference's on the converted weights."""
    cfg, rcfg = _configs(arch)
    params = RLM.init_params(rcfg, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, params)
    model = CV.lm_params_from_numpy(cfg, tree, "cpu")
    assert model.layers[0].moe.router.dtype == torch.float32
    back = CV.lm_params_to_numpy(model)
    assert set(back["layers"]) == set(tree["layers"])
    for name, want in tree["layers"]["moe"].items():
        np.testing.assert_array_equal(back["layers"]["moe"][name], want)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 48)).astype(
        np.int32)
    hidden, aux = RLM.forward(rcfg, params, {"tokens": jnp.asarray(toks)})
    got_h, got_aux = TLM.forward(cfg, model, {"tokens": toks})
    np.testing.assert_allclose(got_h.numpy(), np.asarray(hidden), **MODEL_TOL)
    np.testing.assert_allclose(float(got_aux), float(aux), **FFN_TOL)
    logits, _ = RLM.logits_full(rcfg, params, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(
        TLM.logits_full(cfg, model, {"tokens": toks}).numpy(),
        np.asarray(logits), **MODEL_TOL)
    # a transposed expert tensor is refused by shape
    tree["layers"]["moe"]["w_down"] = np.swapaxes(
        tree["layers"]["moe"]["w_down"], 2, 3)
    with pytest.raises(ValueError, match="w_down"):
        CV.lm_params_from_numpy(cfg, tree, "cpu")


def test_moe_init_scales_and_dtypes():
    """The reference's scales: router, w_gate, w_up d^-0.5 and w_down
    f^-0.5 (not the Linear rule d_in = shape[-1]); the router in f32 in a
    bf16 model."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").smoke(),
                              dtype="bfloat16", d_model=256, d_ff=64)
    model = TLM.init_params(cfg, 0, device="cpu")
    moe = model.layers[1].moe
    assert moe.router.dtype == torch.float32
    d, f = cfg.d_model, cfg.d_ff
    for t, scale in ((moe.router, d ** -0.5), (moe.w_gate, d ** -0.5),
                     (moe.w_up, d ** -0.5), (moe.w_down, f ** -0.5)):
        assert t.dtype == (torch.float32 if t is moe.router
                           else torch.bfloat16)
        assert abs(float(t.float().std()) / scale - 1) < 0.05
