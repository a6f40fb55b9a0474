"""Port parity of the encdec family (Whisper-tiny): LayerNorm, the
encoder over stubbed frame embeddings, the decoder's learned positions
(past the 448-entry table too), cross-attention in prefill and, through
the `lsm_attention` entry point, in decode; `generate`, and the
converter's encoder, cross-attention, `ln3`, `dec_pos` and LayerNorm
bias leaves. The reference runs on the CPU (JAX), the port on the CPU
(torch, the kernel's plain version), on the same numpy inputs carried
by `lm_params_from_numpy` / `caches_from_numpy`, at `smoke()` size.

Tolerances, as `tests/test_torch_lm.py` states them: model logits
rtol = atol = 2e-3 (the reference suite's own), caches 1e-4, LayerNorm
1e-6, the encoder's sinusoid 2.5e-4 (two ulps of its largest f32
angle); bf16 decode within FLOOR_X times the reference's own bf16 error
at each step (its bf16 logits against those of an f32 copy of the
weights).

The reference's forward extends the decoder positions past 448 with a
sinusoid while its decode step clamps to entry 447; the port copies
both. Its `generate(kind="lsm")` raises KeyError (the tiered layout
asked of a dense-only family); the port raises ValueError.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import layers as RLY  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.serving import kv_cache as RKV  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as TLY  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.serving import kv_cache as TKV  # noqa: E402

ARCH = "whisper-tiny"
PROMPT, STEPS = 12, 24
LOGIT_TOL = dict(atol=2e-3, rtol=2e-3)
STATE_TOL = dict(atol=1e-4, rtol=1e-4)
FLOOR_X = 3                     # times the reference's own bf16 error
BF16_STEPS = 12

_ref_decode = jax.jit(RLM.decode_step, static_argnums=(0, 4))
_ref_prefill = jax.jit(RLM.prefill_step, static_argnums=0)
_ref_logits = jax.jit(RLM.logits_full, static_argnums=0)


def _np(x):
    """numpy f32 view of a torch tensor or a jax array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _rel(got, want) -> float:
    g, w = _np(got), _np(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _tree_close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k, w in want.items():
        if w.dtype == jnp.int32:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))
        else:
            _close(got[k], w, **tol)


def _models(seed=1, dtype="float32"):
    cfg = dataclasses.replace(get_config(ARCH).smoke(), dtype=dtype)
    rcfg = dataclasses.replace(ref_config(ARCH).smoke(), dtype=dtype)
    params = RLM.init_params(rcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return cfg, rcfg, params, CV.lm_params_from_numpy(cfg, tree, "cpu")


def _inputs(cfg, n_tokens, seed=0, dtype="float32"):
    """tokens (2, n_tokens) and frames (2, T, d): the frames as a jax
    array and a torch tensor of `dtype`, from one numpy draw."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (2, n_tokens)).astype(np.int32)
    frames = rng.normal(size=(2, cfg.encoder_seq, cfg.d_model))
    jf = jnp.asarray(frames, jnp.dtype(dtype))
    tf = torch.from_numpy(frames.astype(np.float32)).to(getattr(torch, dtype))
    return toks, jf, tf


def _ref_grown(rcfg, caches, max_len):
    """The reference's `generate` cache growth for kind dense."""
    b, s = caches["k"].shape[1:3]
    grown = RLM.init_decode_caches(rcfg, b, max_len, kind="dense")
    for kk in ("k", "v"):
        grown[kk] = grown[kk].at[:, :, :s].set(caches[kk])
    return dict(grown, enc_k=caches["enc_k"], enc_v=caches["enc_v"],
                pos=caches["pos"])


# -- (a) LayerNorm, the sinusoid ----------------------------------------------

def test_layernorm_matches_reference():
    """LayerNorm at 1e-6; the encoder's sinusoid at its 1,500 positions."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 6, 64)) * 3 + 1.5).astype(np.float32)
    w, b = (rng.normal(size=64).astype(np.float32) for _ in range(2))
    got = TLY.layernorm(*(torch.from_numpy(a) for a in (x, w, b)), 1e-6)
    _close(got, RLY.layernorm(*(jnp.asarray(a) for a in (x, w, b)), 1e-6),
           atol=1e-6, rtol=1e-6)
    # f32 angles up to 1,499 rad are rounded to 1.2e-4 (an ulp there),
    # and torch's CPU sin may take another rounding of them in a process
    # (both packages stay within 1.6e-4 of the float64 values): 2.5e-4
    cfg = get_config(ARCH).smoke()
    _close(TLM._sinusoid(1500, 384, "cpu"), RLM._sinusoid(1500, 384),
           atol=2.5e-4, rtol=0)
    assert cfg.norm == "layernorm" and TLM.init_params(
        cfg, 0, device="cpu").enc_norm.b.shape == (cfg.d_model,)


# -- (b) forward and prefill --------------------------------------------------

@pytest.mark.parametrize("s", [PROMPT, 452], ids=["s12", "s452_past_table"])
def test_forward_and_prefill_match_reference(s):
    """logits_full and prefill_step (last logits and every cache leaf:
    k, v, enc_k, enc_v, pos); at S = 452 the decoder positions run past
    the 448-entry table into the sinusoid."""
    cfg, rcfg, params, model = _models()
    toks, jf, tf = _inputs(cfg, s)
    want = _ref_logits(rcfg, params, {"tokens": jnp.asarray(toks),
                                      "frames": jf})[0]
    _close(TLM.logits_full(cfg, model, {"tokens": toks, "frames": tf}),
           want, **LOGIT_TOL)
    lg, caches = TLM.prefill_step(cfg, model, {"tokens": toks,
                                               "frames": tf})
    rlg, rcaches = _ref_prefill(rcfg, params, {"tokens": jnp.asarray(toks),
                                               "frames": jf})
    _close(lg, rlg, **LOGIT_TOL)
    _tree_close(caches, rcaches, **STATE_TOL)
    assert caches["enc_k"].shape == (cfg.n_layers, 2, cfg.encoder_seq,
                                     cfg.n_kv, cfg.hd)


def test_frames_must_be_in_the_model_dtype():
    cfg, _, _, model = _models()
    toks, _, tf = _inputs(cfg, PROMPT)
    with pytest.raises(TypeError, match="frames"):
        TLM.forward(cfg, model, {"tokens": toks, "frames": tf.double()})


# -- (c) teacher-forced decode ------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "lsm"])
def test_teacher_forced_decode_matches_reference(kind):
    """Both packages decode from the reference's grown caches, step by
    step against its `decode_step` and against the full forward; both
    ignore `kind` for this family (the decoder's one layout)."""
    cfg, rcfg, params, model = _models()
    toks, jf, tf = _inputs(cfg, PROMPT + STEPS)
    full = _ref_logits(rcfg, params, {"tokens": jnp.asarray(toks),
                                      "frames": jf})[0]
    prompt = toks[:, :PROMPT]
    _, rcaches = _ref_prefill(rcfg, params, {"tokens": jnp.asarray(prompt),
                                             "frames": jf})
    rcaches = _ref_grown(rcfg, rcaches, PROMPT + STEPS + 8)
    caches = CV.caches_from_numpy(jax.tree.map(np.asarray, rcaches), "cpu")
    assert set(TKV.grow_dense(cfg, TLM.prefill_step(
        cfg, model, {"tokens": prompt, "frames": tf})[1],
        PROMPT + STEPS + 8)) == set(caches)
    for i in range(STEPS):
        tok = toks[:, PROMPT + i]
        lg, caches = TLM.decode_step(cfg, model, torch.from_numpy(tok),
                                     caches, kind)
        rlg, rcaches = _ref_decode(rcfg, params, jnp.asarray(tok), rcaches,
                                   kind)
        _close(lg, rlg, **LOGIT_TOL)
        _close(lg, full[:, PROMPT + i], **LOGIT_TOL)
    _tree_close(caches, rcaches, **STATE_TOL)


def test_decode_past_the_table_clamps_as_the_reference():
    """Decode steps at positions 444-451: the reference's decode step adds
    entry min(pos, 447) of the table (its forward would add the
    sinusoid); the port's does the same."""
    cfg, rcfg, params, model = _models()
    toks, jf, _ = _inputs(cfg, 452)
    _, rcaches = _ref_prefill(rcfg, params, {"tokens": jnp.asarray(
        toks[:, :444]), "frames": jf})
    rcaches = _ref_grown(rcfg, rcaches, 456)
    caches = CV.caches_from_numpy(jax.tree.map(np.asarray, rcaches), "cpu")
    for i in range(444, 452):
        lg, caches = TLM.decode_step(cfg, model, torch.from_numpy(toks[:, i]),
                                     caches)
        rlg, rcaches = _ref_decode(rcfg, params, jnp.asarray(toks[:, i]),
                                   rcaches, "dense")
        _close(lg, rlg, **LOGIT_TOL)
    _tree_close(caches, rcaches, **STATE_TOL)


def test_teacher_forced_decode_bf16_matches_reference():
    """bf16 frames and weights: prefill and BF16_STEPS decode steps from
    the reference's bf16 caches, each step's logits within FLOOR_X times
    the reference's own bf16 error there (against an f32 copy of the
    weights and frames, decoding from its own f32 caches)."""
    cfg, rcfg, params, model = _models(dtype="bfloat16")
    rcfg32 = ref_config(ARCH).smoke()
    params32 = jax.tree.map(lambda t: t.astype(jnp.float32), params)
    toks, jf, tf = _inputs(cfg, PROMPT + BF16_STEPS, dtype="bfloat16")
    jf32 = jf.astype(jnp.float32)
    prompt = jnp.asarray(toks[:, :PROMPT])
    lg, _ = TLM.prefill_step(cfg, model, {"tokens": toks[:, :PROMPT],
                                          "frames": tf})
    rlg, rcaches = _ref_prefill(rcfg, params, {"tokens": prompt,
                                               "frames": jf})
    rlg32, rcaches32 = _ref_prefill(rcfg32, params32, {"tokens": prompt,
                                                       "frames": jf32})
    errs, floors = [_rel(lg, rlg)], [_rel(rlg, rlg32)]
    max_len = PROMPT + BF16_STEPS + 8
    rcaches = _ref_grown(rcfg, rcaches, max_len)
    rcaches32 = _ref_grown(rcfg32, rcaches32, max_len)
    caches = CV.caches_from_numpy(jax.tree.map(np.asarray, rcaches), "cpu")
    for i in range(BF16_STEPS):
        tok = toks[:, PROMPT + i]
        lg, caches = TLM.decode_step(cfg, model, torch.from_numpy(tok),
                                     caches)
        rlg, rcaches = _ref_decode(rcfg, params, jnp.asarray(tok), rcaches,
                                   "dense")
        rlg32, rcaches32 = _ref_decode(rcfg32, params32, jnp.asarray(tok),
                                       rcaches32, "dense")
        errs.append(_rel(lg, rlg))
        floors.append(_rel(rlg, rlg32))
    assert all(e <= FLOOR_X * f for e, f in zip(errs, floors)), (errs, floors)
    assert all(caches[k].dtype == torch.bfloat16
               for k in ("k", "v", "enc_k", "enc_v"))


# -- (d) generate -------------------------------------------------------------

def test_generate_matches_reference():
    """Greedy tokens and caches of the port's `generate` against the
    reference's (token for token, or up to a near tie)."""
    cfg, rcfg, params, model = _models(seed=2)
    toks, jf, tf = _inputs(cfg, PROMPT, seed=3)
    got, caches = TKV.generate(cfg, model, {"tokens": toks, "frames": tf},
                               STEPS)
    want, rcaches = RKV.generate(rcfg, params, {"tokens": jnp.asarray(toks),
                                                "frames": jf}, STEPS)
    got, want = got.numpy(), np.asarray(want)
    if not np.array_equal(got, want):
        first = int(np.argmax((got != want).any(axis=0)))
        np.testing.assert_array_equal(got[:, :first], want[:, :first])
        lg = _ref_logits(rcfg, params, {"tokens": jnp.asarray(np.concatenate(
            [toks, want[:, :first]], axis=1)), "frames": jf})[0][:, -1]
        top2 = np.sort(np.asarray(lg), axis=-1)[:, -2:]
        differ = got[:, first] != want[:, first]
        assert ((top2[:, 1] - top2[:, 0])[differ] <= 1e-3).all()
        return
    _tree_close(caches, rcaches, **STATE_TOL)


def test_generate_lsm_raises_in_both_packages():
    cfg, rcfg, params, model = _models(seed=2)
    toks, jf, tf = _inputs(cfg, PROMPT, seed=3)
    with pytest.raises(ValueError, match="448 positions"):
        TKV.generate(cfg, model, {"tokens": toks, "frames": tf}, 4, "lsm")
    with pytest.raises(KeyError):
        RKV.generate(rcfg, params, {"tokens": jnp.asarray(toks),
                                    "frames": jf}, 4, "lsm")
    _, dense = TLM.prefill_step(cfg, model, {"tokens": toks, "frames": tf})
    with pytest.raises(ValueError, match="448 positions"):
        TKV.lsm_from_dense(cfg, dense, 40)


# -- (e) parameters and the converter -----------------------------------------

def test_init_params_scales():
    """The reference's scales: dec_pos x0.01, LayerNorm w 1 and b 0."""
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    model = TLM.init_params(cfg, 0, device="cpu")
    assert abs(float(model.dec_pos.std()) / 0.01 - 1) < 0.05
    assert model.dec_pos.shape == (448, cfg.d_model)
    norms = [m for m in model.modules() if isinstance(m, TLY.Norm)]
    assert len(norms) == 3 * cfg.n_layers + 2 * cfg.encoder_layers + 2
    assert all((n.w == 1).all() and not n.b.any() for n in norms)
    wq = model.layers[0].cross.wq.weight
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("case", ["roundtrip", "missing_leaf", "unused_leaf",
                                  "caches_roundtrip"])
def test_converter(case):
    cfg, rcfg, params, model = _models(seed=4)
    tree = jax.tree.map(np.asarray, params)
    if case == "roundtrip":
        got = CV.lm_params_to_numpy(model)
        assert jax.tree.structure(got) == jax.tree.structure(tree)
        jax.tree.map(np.testing.assert_array_equal, got, tree)
        assert {"enc_layers", "enc_norm", "dec_pos"} <= set(got)
        assert {"cross", "ln3"} <= set(got["layers"])
        assert set(got["enc_norm"]) == {"w", "b"}
    elif case == "missing_leaf":
        del tree["layers"]["ln3"]["b"]
        with pytest.raises(KeyError, match="ln3/b"):
            CV.lm_params_from_numpy(cfg, tree, "cpu")
    elif case == "unused_leaf":
        tree["enc_layers"]["cross"] = tree["layers"]["cross"]
        with pytest.raises(KeyError, match="enc_layers/cross"):
            CV.lm_params_from_numpy(cfg, tree, "cpu")
    else:
        rng = np.random.default_rng(5)
        ref = jax.tree.map(np.asarray, RLM.init_decode_caches(rcfg, 2, 40))
        ref = {k: (rng.normal(size=a.shape).astype(a.dtype)
                   if a.dtype == np.float32
                   else rng.integers(0, 9, a.shape).astype(a.dtype))
               for k, a in ref.items()}
        port = CV.caches_from_numpy(ref, "cpu")
        for kind in ("dense", "lsm"):       # one layout for either kind
            init = TLM.init_decode_caches(cfg, 2, 40, kind, device="cpu")
            assert {k: (t.shape, t.dtype) for k, t in port.items()} == {
                k: (t.shape, t.dtype) for k, t in init.items()}
        back = CV.caches_to_numpy(port)
        jax.tree.map(np.testing.assert_array_equal, back, ref)
