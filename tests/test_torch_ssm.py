"""Port parity of the ssm and hybrid families (Mamba2-370M, Zamba2-1.2B):
`models/ssm.py` (the chunked SSD, the Mamba-2 mixer's forward, prefill
and decode), their branches of `models/lm.py`, `serving/kv_cache.py`
on the hybrid's `shared` stack, and the converter's mixer and shared
leaves, against the reference on the same numpy inputs, at `smoke()`
size in f32 (JAX on the CPU, torch on the CPU), and the mixer and
teacher-forced decode in bf16.

Tolerances, as `tests/test_torch_lm.py` states them: model logits
rtol = atol = 2e-3 (the reference suite's own), caches 1e-4 (f32
products in another order). The SSD and the mixer rtol 1e-4 with atol
1e-4 of the largest output: the reference's segsum subtracts cumulative
sums of dt*A that reach ~-300 within a chunk (an f32 ulp there is 3e-5),
so its error follows the size of its output, not of each element.
In bf16 the two packages round different intermediates (XLA fuses the
convolution's elementwise chain): the mixer's outputs and states are held
at rel L2 8e-3 (`test_torch_lm.py`'s bf16 rtol), the convolution history
bitwise, and the f32 state after decode steps at rel L2 1e-3; the
model's logits at each step within FLOOR_X times the reference's own
bf16 error at that step (its bf16 logits against its f32 logits of the
same weights).

The reference's `generate` has two faults on these families, which the
port does not copy: for hybrid, kind "dense" decodes over a `shared`
cache left at the prompt's length, so every step's write is clamped onto
the last prompt slot; kind "lsm" raises KeyError('k') for both families.
The port is held against the reference's prefill and `decode_step` loop
with the cache grown (`tests/test_models.py` grows it by hand) or tiered
on the `shared` stack.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.models import ssm as RSSM  # noqa: E402
from repro.serving import kv_cache as RKV  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import (HYBRID_ARCHS, SSM_ARCHS,  # noqa: E402
                                 get_config)
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.serving import kv_cache as TKV  # noqa: E402

ARCHS = [a.replace("_", "-") for a in SSM_ARCHS + HYBRID_ARCHS]
MAMBA, ZAMBA = ARCHS
PROMPT, STEPS = 96, 64          # smoke: W=64, mu=16, topk=2 -> seals
MAX_LEN = PROMPT + STEPS + 8
LOGIT_TOL = dict(atol=2e-3, rtol=2e-3)
STATE_TOL = dict(atol=1e-4, rtol=1e-4)
SSD_REL = 1e-4
BF16_REL = 8e-3                 # rel L2 of the bf16 mixer's outputs
DECODE_STATE_REL = 1e-3         # rel L2 of the f32 state after decode
BF16_STEPS = 16                 # teacher-forced bf16 decode steps
FLOOR_X = 3                     # times the reference's own bf16 error

_ref_decode = jax.jit(RLM.decode_step, static_argnums=(0, 4))
_ref_prefill = jax.jit(RLM.prefill_step, static_argnums=0)
_ref_mixer = {name: jax.jit(getattr(RSSM, f"mamba2_{name}"), static_argnums=0)
              for name in ("forward", "prefill", "decode")}


def _np(x):
    """numpy f32 view of a torch tensor or a jax array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _ssd_close(got, want):
    """Within SSD_REL relative plus SSD_REL of the largest |want|."""
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=SSD_REL,
                               atol=SSD_REL * float(np.abs(w).max()))


def _rel(got, want) -> float:
    g, w = _np(got), _np(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _tree_close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _tree_close(got[k], w, **tol)
        elif w.dtype == jnp.int32:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))
        else:
            _close(got[k], w, **tol)


def _models(arch, seed=1, dtype="float32"):
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
    rcfg = dataclasses.replace(ref_config(arch).smoke(), dtype=dtype)
    params = RLM.init_params(rcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return cfg, rcfg, params, CV.lm_params_from_numpy(cfg, tree, "cpu")


def _tokens(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (2, PROMPT + STEPS)).astype(np.int32)


# -- the reference's caches, as its own tests build them ----------------------

def _ref_grown(caches, max_len):
    """The reference's dense caches with every stacked K/V (the hybrid's
    `shared` too) grown to max_len, as `tests/test_models.py` grows them."""
    def grow(t):
        pad = jnp.zeros(t.shape[:2] + (max_len,) + t.shape[3:], t.dtype)
        return pad.at[:, :, :t.shape[2]].set(t)
    caches = dict(caches)
    if "shared" in caches:
        caches["shared"] = {k: grow(t) for k, t in caches["shared"].items()}
    return caches


def _stack_cfg(rcfg, n):
    """A dense-family reference config over a stack of n K/V slots: the
    reference's `lsm_from_dense` and `seal_hot_block` read top-level
    k/v and hot_* leaves, so the hybrid's `shared` stack goes through
    them as an n-layer dense cache."""
    return dataclasses.replace(rcfg, family="dense", n_layers=n)


def _ref_tiered(rcfg, caches, max_len):
    shared = caches["shared"]
    scfg = _stack_cfg(rcfg, shared["k"].shape[0])
    tiered = RKV.lsm_from_dense(scfg, dict(shared, pos=caches["pos"]),
                                max_len)
    tiered.pop("pos")
    return dict(caches, shared=tiered)


def _ref_seal(rcfg, caches):
    shared = caches["shared"]
    scfg = _stack_cfg(rcfg, shared["hot_k"].shape[0])
    return dict(caches, shared=RKV.seal_hot_block_jit(scfg, shared))


def _ref_full(rcfg, shared_caches):
    return int(shared_caches["hot_len"][0, 0]) >= rcfg.lsm_hot_window


def _ref_loop(rcfg, params, prompt, steps, kind):
    """Greedy decoding with the reference's prefill and `decode_step`,
    the caches grown (dense) or tiered on the shared stack and sealed by
    the host (lsm) -> (tokens (B, steps), each step's logits)."""
    lg, caches = _ref_prefill(rcfg, params, {"tokens": jnp.asarray(prompt)})
    caches = (_ref_tiered(rcfg, caches, MAX_LEN) if kind == "lsm"
              else _ref_grown(caches, MAX_LEN))
    logits = [np.asarray(lg)]
    for _ in range(steps - 1):
        tok = jnp.argmax(jnp.asarray(logits[-1]), -1).astype(jnp.int32)
        lg, caches = _ref_decode(rcfg, params, tok, caches, kind)
        logits.append(np.asarray(lg))
        if kind == "lsm" and _ref_full(rcfg, caches["shared"]):
            caches = _ref_seal(rcfg, caches)
    return np.stack([lg.argmax(-1) for lg in logits], axis=1), logits


# -- (a) configurations -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for f in (lambda c: c, lambda c: c.smoke()):
        cfg, rcfg = f(get_config(arch)), f(ref_config(arch))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        assert (cfg.d_inner, cfg.ssm_heads, cfg.is_attention_free) == (
            rcfg.d_inner, rcfg.ssm_heads, rcfg.is_attention_free)


# -- (b) the chunked SSD and the mixer ----------------------------------------

@pytest.mark.parametrize("case", ["chunk_lt_s", "h0", "groups2",
                                  "chunk_eq_s"])
def test_ssd_chunked_matches_reference(case):
    """(y, h_final) against the reference's einsum form: S over several
    chunks, an initial state, two B/C groups (4 heads each), one chunk."""
    rng = np.random.default_rng(len(case))
    b, s, h, p, n = 2, 64, 8, 16, 16
    g = 2 if case == "groups2" else 1
    chunk = s if case == "chunk_eq_s" else 16
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    bb, cc = (rng.normal(size=(b, s, g, n)).astype(np.float32)
              for _ in range(2))
    h0 = (rng.normal(size=(b, h, p, n)).astype(np.float32)
          if case == "h0" else None)
    got = TSSM.ssd_chunked(*(torch.from_numpy(t) for t in (x, dt, a, bb,
                                                           cc)),
                           chunk=chunk,
                           h0=None if h0 is None else torch.from_numpy(h0))
    want = RSSM.ssd_chunked(*(jnp.asarray(t) for t in (x, dt, a, bb, cc)),
                            chunk=chunk,
                            h0=None if h0 is None else jnp.asarray(h0))
    for gt, wt in zip(got, want):
        _ssd_close(gt, wt)
    with pytest.raises(ValueError, match="multiple"):
        TSSM.ssd_chunked(*(torch.from_numpy(t[:, :s - 1])
                           for t in (x, dt)), torch.from_numpy(a),
                         *(torch.from_numpy(t[:, :s - 1]) for t in (bb, cc)),
                         chunk=chunk)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba2_mixer_matches_reference(arch):
    """Layer 0's mixer: forward, prefill (output and both states), then
    four decode steps from the prefill's state (outputs and states)."""
    cfg, rcfg, params, model = _models(arch, seed=2)
    rp = jax.tree.map(lambda t: t[0], params["layers"]["mixer"])
    tp = model.layers[0].mixer
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 36, cfg.d_model)).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _ssd_close(TSSM.mamba2_forward(cfg, tp, tx[:, :32]),
               _ref_mixer["forward"](rcfg, rp, jx[:, :32]))
    y, st = TSSM.mamba2_prefill(cfg, tp, tx[:, :32])
    ry, rst = _ref_mixer["prefill"](rcfg, rp, jx[:, :32])
    _ssd_close(y, ry)
    for t in range(32, 36):
        for k in ("ssm", "conv"):
            _ssd_close(st[k], rst[k])
        y = TSSM.mamba2_decode(cfg, tp, tx[:, t:t + 1], st)
        ry, rst = _ref_mixer["decode"](rcfg, rp, jx[:, t:t + 1], rst)
        _ssd_close(y, ry)
    for k in ("ssm", "conv"):
        _ssd_close(st[k], rst[k])


def test_mamba2_mixer_bf16_matches_reference():
    """The mixer in bf16, the reference's dtype choices: the prefill's
    convolution in bf16, its history kept in bf16 (equal bitwise), the
    decode's convolution in f32 over it, the SSD and the `ssm` state in
    f32. After four decode steps the state, made in f32 from equal bf16
    inputs, is held at DECODE_STATE_REL (a bf16 decode convolution
    moves it by ~6e-3)."""
    cfg, rcfg, params, model = _models(MAMBA, seed=2, dtype="bfloat16")
    rp = jax.tree.map(lambda t: t[0], params["layers"]["mixer"])
    tp = model.layers[0].mixer
    x = np.random.default_rng(3).normal(size=(2, 36, cfg.d_model))
    tx = torch.from_numpy(x.astype(np.float32)).bfloat16()
    jx = jnp.asarray(x, jnp.bfloat16)
    y, st = TSSM.mamba2_prefill(cfg, tp, tx[:, :32])
    ry, rst = _ref_mixer["prefill"](rcfg, rp, jx[:, :32])
    assert y.dtype == torch.bfloat16
    assert (st["ssm"].dtype, st["conv"].dtype) == (torch.float32,
                                                   torch.bfloat16)
    assert _rel(y, ry) <= BF16_REL and _rel(st["ssm"], rst["ssm"]) <= BF16_REL
    for t in range(32, 36):
        np.testing.assert_array_equal(_np(st["conv"]), _np(rst["conv"]))
        y = TSSM.mamba2_decode(cfg, tp, tx[:, t:t + 1], st)
        ry, rst = _ref_mixer["decode"](rcfg, rp, jx[:, t:t + 1], rst)
        assert _rel(y, ry) <= BF16_REL
    np.testing.assert_array_equal(_np(st["conv"]), _np(rst["conv"]))
    assert _rel(st["ssm"], rst["ssm"]) <= DECODE_STATE_REL


# -- (c) prefill and teacher-forced decode ------------------------------------

@pytest.mark.parametrize("arch,kind", [(MAMBA, "dense"), (ZAMBA, "dense"),
                                       (ZAMBA, "lsm")])
def test_teacher_forced_decode_matches_reference(arch, kind):
    """Prefill (logits, states, the shared K/V) against the reference;
    then both packages decode from the reference's caches (grown, or
    tiered on the shared stack), step by step against its `decode_step`
    and, dense, against the full forward; tiered through a seal, held
    against the reference's seal of the shared stack."""
    cfg, rcfg, params, model = _models(arch)
    toks = _tokens(cfg)
    full = RLM.logits_full(rcfg, params, {"tokens": jnp.asarray(toks)})[0]
    prompt = {"tokens": toks[:, :PROMPT]}
    lg, caches = TLM.prefill_step(cfg, model, prompt)
    rlg, rcaches = _ref_prefill(rcfg, params,
                                {"tokens": jnp.asarray(prompt["tokens"])})
    _close(lg, rlg, **LOGIT_TOL)
    _close(lg, full[:, PROMPT - 1], **LOGIT_TOL)
    _tree_close(caches, rcaches, **STATE_TOL)
    if kind == "lsm":
        rcaches = _ref_tiered(rcfg, rcaches, MAX_LEN)
        _tree_close(TKV.lsm_from_dense(cfg, caches, MAX_LEN), rcaches,
                    **STATE_TOL)
    else:
        rcaches = _ref_grown(rcaches, MAX_LEN)
        _tree_close(TKV.grow_dense(cfg, caches, MAX_LEN), rcaches,
                    **STATE_TOL)
    caches = CV.caches_from_numpy(jax.tree.map(np.asarray, rcaches), "cpu")
    seals = 0
    for i in range(STEPS):
        tok = toks[:, PROMPT + i]
        lg, caches = TLM.decode_step(cfg, model, torch.from_numpy(tok),
                                     caches, kind)
        rlg, rcaches = _ref_decode(rcfg, params, jnp.asarray(tok), rcaches,
                                   kind)
        _close(lg, rlg, **LOGIT_TOL)
        if kind == "dense":
            _close(lg, full[:, PROMPT + i], **LOGIT_TOL)
        elif _ref_full(rcfg, rcaches["shared"]):
            caches = TKV.seal_hot_block(cfg, caches)
            rcaches = _ref_seal(rcfg, rcaches)
            _tree_close(caches, rcaches, **STATE_TOL)
            seals += 1
    _tree_close(caches, rcaches, **STATE_TOL)
    if kind == "lsm":
        assert seals >= 1
        assert int(caches["shared"]["n_blocks"].min()) > cfg.lsm_topk


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_bf16_matches_reference(arch):
    """bf16 prefill and BF16_STEPS dense decode steps from the
    reference's bf16 caches, against its `decode_step`: each step's
    logits within FLOOR_X times the reference's own bf16 error there
    (its bf16 logits against those of an f32 copy of the weights, which
    decodes from its own f32 caches); the caches keep their dtypes."""
    cfg, rcfg, params, model = _models(arch, dtype="bfloat16")
    rcfg32 = ref_config(arch).smoke()
    params32 = jax.tree.map(lambda t: t.astype(jnp.float32), params)
    toks = _tokens(cfg)
    prompt = jnp.asarray(toks[:, :PROMPT])
    lg, caches = TLM.prefill_step(cfg, model, {"tokens": toks[:, :PROMPT]})
    rlg, rcaches = _ref_prefill(rcfg, params, {"tokens": prompt})
    rlg32, rcaches32 = _ref_prefill(rcfg32, params32, {"tokens": prompt})
    errs, floors = [_rel(lg, rlg)], [_rel(rlg, rlg32)]
    rcaches = _ref_grown(rcaches, MAX_LEN)
    rcaches32 = _ref_grown(rcaches32, MAX_LEN)
    caches = CV.caches_from_numpy(jax.tree.map(np.asarray, rcaches), "cpu")
    for i in range(BF16_STEPS):
        tok = toks[:, PROMPT + i]
        lg, caches = TLM.decode_step(cfg, model, torch.from_numpy(tok),
                                     caches, "dense")
        rlg, rcaches = _ref_decode(rcfg, params, jnp.asarray(tok), rcaches,
                                   "dense")
        rlg32, rcaches32 = _ref_decode(rcfg32, params32, jnp.asarray(tok),
                                       rcaches32, "dense")
        errs.append(_rel(lg, rlg))
        floors.append(_rel(rlg, rlg32))
    assert all(e <= FLOOR_X * f for e, f in zip(errs, floors)), (errs, floors)
    for k, w in (("ssm", torch.float32), ("conv", torch.bfloat16)):
        assert caches[k].dtype == w
    if arch == ZAMBA:
        assert caches["shared"]["k"].dtype == torch.bfloat16


# -- (d) generate -------------------------------------------------------------

def _same_tokens_or_near_tie(toks, want, logits):
    """Token for token, or equal up to a step where the reference's top-2
    margin is at most 1e-3 (past a near tie the two decodes follow other
    tokens)."""
    if np.array_equal(toks, want):
        return
    first = int(np.argmax((toks != want).any(axis=0)))
    np.testing.assert_array_equal(toks[:, :first], want[:, :first])
    top2 = np.sort(logits[first], axis=-1)[:, -2:]
    differ = toks[:, first] != want[:, first]
    assert ((top2[:, 1] - top2[:, 0])[differ] <= 1e-3).all(), \
        "tokens differ where the reference's top-2 margin exceeds 1e-3"


@pytest.mark.parametrize("arch,kind", [(MAMBA, "dense"), (ZAMBA, "dense"),
                                       (ZAMBA, "lsm"), (MAMBA, "lsm")])
def test_generate_matches_reference(arch, kind):
    """The port's `generate` against the reference's prefill and decode
    loop. Mamba2 dense: the reference's `generate` is that loop. Zamba2
    dense: the reference's `generate` leaves the shared cache at the
    prompt's length and differs from its own loop; the port does not.
    Tiered: the reference's `generate` raises KeyError for both
    families; the port decodes Zamba2 through seals and refuses Mamba2
    (no KV cache) with ValueError."""
    cfg, rcfg, params, model = _models(arch, seed=2)
    prompt = _tokens(cfg, seed=3)[:, :PROMPT]
    jprompt = {"tokens": jnp.asarray(prompt)}
    if arch == MAMBA and kind == "lsm":
        with pytest.raises(ValueError, match="no KV cache"):
            TKV.generate(cfg, model, {"tokens": prompt}, STEPS, kind)
        with pytest.raises(KeyError):
            RKV.generate(rcfg, params, jprompt, STEPS, kind)
        # decode_step takes either kind for an ssm model, as the
        # reference's does
        _, dense = TLM.prefill_step(cfg, model, {"tokens": prompt})
        tok = torch.from_numpy(prompt[:, -1])
        lg = [TLM.decode_step(cfg, model, tok, TKV.grow_dense(
            cfg, dense, MAX_LEN), k)[0] for k in ("dense", "lsm")]
        assert torch.equal(*lg)
        return
    stats = {}
    toks, caches = TKV.generate(cfg, model, {"tokens": prompt}, STEPS, kind,
                                stats=stats)
    want, logits = _ref_loop(rcfg, params, prompt, STEPS, kind)
    _same_tokens_or_near_tie(toks.numpy(), want, logits)
    if kind == "lsm":
        assert stats["seals"] >= 1
        with pytest.raises(KeyError):
            RKV.generate(rcfg, params, jprompt, STEPS, kind)
        return
    rtoks = np.asarray(RKV.generate(rcfg, params, jprompt, STEPS, kind)[0])
    if arch == MAMBA:
        np.testing.assert_array_equal(rtoks, want)
    else:      # the reference's fault: the prefill's token agrees, then
        assert (rtoks[:, 0] == want[:, 0]).all()   # each decode step's
        assert not np.array_equal(rtoks, want)     # write is clamped


def test_decode_refuses_a_write_past_the_shared_cache():
    """Where the reference clamps a write past the cache (the source of
    its dense hybrid `generate` fault), the port raises; `grow_dense`
    gives it room."""
    cfg, _, _, model = _models(ZAMBA)
    prompt = _tokens(cfg)[:, :PROMPT]
    _, dense = TLM.prefill_step(cfg, model, {"tokens": prompt})
    tok = torch.from_numpy(prompt[:, -1])
    with pytest.raises(IndexError, match="outside the dense cache"):
        TLM.decode_step(cfg, model, tok, dense, "dense")
    grown = TKV.grow_dense(cfg, dense, PROMPT + 1)
    assert grown["shared"]["k"].shape[2] == PROMPT + 1
    _, grown = TLM.decode_step(cfg, model, tok, grown, "dense")
    with pytest.raises(IndexError, match="outside the dense cache"):
        TLM.decode_step(cfg, model, tok, grown, "dense")


# -- (e) parameters and the converter -----------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_scales(arch):
    """The reference's scales; A_log, dt_bias and D f32 in a bf16 model."""
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="bfloat16")
    model = TLM.init_params(cfg, 0, device="cpu")
    for lp in model.layers:
        m = lp.mixer
        h, k = cfg.ssm_heads, cfg.ssm_conv
        assert m.A_log.dtype == m.dt_bias.dtype == m.D.dtype == torch.float32
        assert m.in_proj.dtype == m.conv_w.dtype == torch.bfloat16
        _close(m.A_log, np.log(np.linspace(1.0, 16.0, h)), atol=1e-6,
               rtol=1e-6)
        assert not m.dt_bias.any() and not m.conv_b.float().any()
        assert (m.D == 1).all() and (m.out_norm.float() == 1).all()
        for t, d_in in ((m.in_proj, cfg.d_model), (m.conv_w, k),
                        (m.out_proj, cfg.d_inner)):
            assert abs(float(t.float().std()) * d_in ** 0.5 - 1) < 0.2
    if arch == ZAMBA:
        assert (model.shared.ln1.w.float() == 1).all()
        wq = model.shared.attn.wq.weight.float()
        assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1) < 0.2


@pytest.mark.parametrize("case", ["roundtrip", "transposed_raises",
                                  "missing_leaf", "unused_leaf",
                                  "caches_roundtrip"])
@pytest.mark.parametrize("arch", ARCHS)
def test_converter(arch, case):
    cfg, rcfg, params, model = _models(arch, seed=4)
    tree = jax.tree.map(np.asarray, params)
    mixer = tree["layers"]["mixer"]
    if case == "roundtrip":
        got = CV.lm_params_to_numpy(model)
        assert jax.tree.structure(got) == jax.tree.structure(tree)
        jax.tree.map(np.testing.assert_array_equal, got, tree)
    elif case == "transposed_raises":      # (d, n) stored as (n, d)
        mixer["in_proj"] = np.swapaxes(mixer["in_proj"], 1, 2)
        with pytest.raises(ValueError, match="in_proj"):
            CV.lm_params_from_numpy(cfg, tree, "cpu")
    elif case == "missing_leaf":
        if arch == ZAMBA:
            del tree["shared"]["attn"]["wk"]
        else:
            del mixer["A_log"]
        with pytest.raises(KeyError, match="wk" if arch == ZAMBA
                           else "A_log"):
            CV.lm_params_from_numpy(cfg, tree, "cpu")
    elif case == "unused_leaf":
        mixer["extra"] = mixer["D"]
        with pytest.raises(KeyError, match="extra"):
            CV.lm_params_from_numpy(cfg, tree, "cpu")
    else:
        # bf16 caches keep their dtypes both ways: ssm f32, conv bf16
        rng = np.random.default_rng(5)
        bcfg = dataclasses.replace(cfg, dtype="bfloat16")
        kinds = ("dense",) if arch == MAMBA else ("dense", "lsm")
        for kind in kinds:
            ref = jax.tree.map(np.asarray, RLM.init_decode_caches(
                dataclasses.replace(rcfg, dtype="bfloat16"), 2, 40,
                kind=kind))
            ref = jax.tree.map(
                lambda a: (rng.normal(size=a.shape).astype(a.dtype)
                           if a.dtype != np.int32
                           else rng.integers(0, 9, a.shape).astype(a.dtype)),
                ref)
            port = CV.caches_from_numpy(ref, "cpu")
            init = TLM.init_decode_caches(bcfg, 2, 40, kind, device="cpu")
            assert jax.tree.structure(port) == jax.tree.structure(init)
            for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(init)):
                assert (a.shape, a.dtype) == (b.shape, b.dtype)
            assert port["ssm"].dtype == torch.float32
            assert port["conv"].dtype == torch.bfloat16
            back = CV.caches_to_numpy(port)
            assert jax.tree.structure(back) == jax.tree.structure(ref)
            jax.tree.map(lambda a, b: np.testing.assert_array_equal(
                a.view(np.uint8), b.view(np.uint8)), back, ref)
