"""Port parity of the vlm family (Qwen2-VL-7B's text backbone): M-RoPE
over three distinct position streams (an image-like t/h/w grid inside
the prompt), forward, prefill, dense decode (M-RoPE with equal streams)
and tiered decode (plain RoPE, as in the reference) through a seal,
`generate`, and the converter, against the reference on the same numpy
inputs at `smoke()` size in f32 (JAX on the CPU; torch on the CPU, the
`lsm_attention` kernel's plain version).

Tolerances, as `tests/test_torch_lm.py` states them: model logits
rtol = atol = 2e-3 (the reference suite's own), caches 1e-4; M-RoPE
1e-5 (f32 angles, products in another order) and, with equal streams,
bit for bit `apply_rope`.
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

ARCH = "qwen2-vl-7b"
PROMPT, STEPS = 96, 64          # smoke: W=64, mu=16, topk=2 -> seals
MAX_LEN = PROMPT + STEPS + 8
LOGIT_TOL = dict(atol=2e-3, rtol=2e-3)
STATE_TOL = dict(atol=1e-4, rtol=1e-4)

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


def _tree_close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k, w in want.items():
        if w.dtype == jnp.int32:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))
        else:
            _close(got[k], w, **tol)


def grid_positions3(b: int, s: int, text: int = 8, grid=(8, 8)):
    """Qwen2-VL's (t, h, w) position streams (3, b, s) for `text` text
    tokens, an image of grid[0] x grid[1] patches (t fixed, h and w
    walking the grid), then text again from the largest position + 1;
    text positions are equal in all three streams."""
    gh, gw = grid
    n_img = gh * gw
    pos = np.zeros((3, s), np.int32)
    pos[:, :text] = np.arange(text)
    pos[0, text:text + n_img] = text
    pos[1, text:text + n_img] = text + np.repeat(np.arange(gh), gw)
    pos[2, text:text + n_img] = text + np.tile(np.arange(gw), gh)
    after = text + max(gh, gw)
    pos[:, text + n_img:] = after + np.arange(s - text - n_img)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b, s)))


def _models(seed=1):
    cfg, rcfg = get_config(ARCH).smoke(), ref_config(ARCH).smoke()
    params = RLM.init_params(rcfg, jax.random.PRNGKey(seed))
    # the reference initialises q/k/v biases to 0: draw them, so the
    # converter and the model are held with biases that matter
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, params)
    for leaf in ("bq", "bk", "bv"):
        a = tree["layers"]["attn"][leaf]
        tree["layers"]["attn"][leaf] = (rng.normal(size=a.shape) * 0.1
                                        ).astype(a.dtype)
    params = jax.tree.map(jnp.asarray, tree)
    return cfg, rcfg, params, CV.lm_params_from_numpy(cfg, tree, "cpu")


def _batches(toks, pos3):
    return ({"tokens": toks, "positions3": torch.from_numpy(pos3)},
            {"tokens": jnp.asarray(toks), "positions3": jnp.asarray(pos3)})


def _tokens(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (2, PROMPT + STEPS)).astype(np.int32)


# -- (a) M-RoPE ---------------------------------------------------------------

@pytest.mark.parametrize("hd,sections,theta", [(16, (4, 2, 2), 1e6),
                                               (128, (16, 24, 24), 1e6)])
def test_apply_mrope_matches_reference(hd, sections, theta):
    """Three distinct streams (an image grid): against the reference;
    three equal streams: `apply_rope` bit for bit."""
    rng = np.random.default_rng(hd)
    s = 80
    x = rng.normal(size=(2, s, 3, hd)).astype(np.float32)
    pos3 = grid_positions3(2, s)
    pos3[:, 1] += 1000                       # the second row elsewhere
    got = TLY.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), theta,
                          sections)
    _close(got, RLY.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta,
                                sections), atol=1e-5, rtol=1e-5)
    rope = TLY.apply_rope(torch.from_numpy(x), torch.from_numpy(pos3[0]),
                          theta)
    assert not torch.equal(got, rope)        # the streams do differ
    same = np.broadcast_to(pos3[:1], pos3.shape)
    assert torch.equal(TLY.apply_mrope(torch.from_numpy(x), torch.from_numpy(
        np.ascontiguousarray(same)), theta, sections), rope)
    with pytest.raises(AssertionError):
        TLY.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), theta,
                        (4, 2, 1))


# -- (b) forward and prefill --------------------------------------------------

def test_forward_and_prefill_match_reference():
    """Distinct positions3: logits_full, prefill logits and caches; the
    port run without them (plain positions) must miss the reference."""
    cfg, rcfg, params, model = _models()
    toks = _tokens(cfg)[:, :PROMPT]
    pos3 = grid_positions3(2, PROMPT)
    tb, jb = _batches(toks, pos3)
    want = _ref_logits(rcfg, params, jb)[0]
    _close(TLM.logits_full(cfg, model, tb), want, **LOGIT_TOL)
    with pytest.raises(AssertionError):
        _close(TLM.logits_full(cfg, model, {"tokens": toks}), want,
               **LOGIT_TOL)
    lg, caches = TLM.prefill_step(cfg, model, tb)
    rlg, rcaches = _ref_prefill(rcfg, params, jb)
    _close(lg, rlg, **LOGIT_TOL)
    _tree_close(caches, rcaches, **STATE_TOL)


# -- (c) teacher-forced decode ------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "lsm"])
def test_teacher_forced_decode_matches_reference(kind):
    """Prefill over an image-grid prompt, then both packages decode from
    the reference's caches (grown, or tiered), step by step against its
    `decode_step`, and (dense) against the full forward with each decoded
    token's three streams at its index, which is what decode applies;
    tiered through a seal, n_blocks > topk at the end."""
    cfg, rcfg, params, model = _models()
    toks = _tokens(cfg)
    pos3 = grid_positions3(2, PROMPT + STEPS)
    pos3[:, :, PROMPT:] = np.arange(PROMPT, PROMPT + STEPS)
    full = _ref_logits(rcfg, params, _batches(toks, pos3)[1])[0]
    tb, jb = _batches(toks[:, :PROMPT], np.ascontiguousarray(
        pos3[:, :, :PROMPT]))
    _, rcaches = _ref_prefill(rcfg, params, jb)
    if kind == "lsm":
        rcaches = RKV.lsm_from_dense(rcfg, rcaches, MAX_LEN)
        _tree_close(TKV.lsm_from_dense(cfg, TLM.prefill_step(
            cfg, model, tb)[1], MAX_LEN), rcaches, **STATE_TOL)
    else:
        grown = RLM.init_decode_caches(rcfg, 2, MAX_LEN)
        rcaches = dict(rcaches, **{k: grown[k].at[:, :, :PROMPT].set(
            rcaches[k]) for k in ("k", "v")})
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
        elif int(rcaches["hot_len"][0, 0]) >= rcfg.lsm_hot_window:
            caches = TKV.seal_hot_block(cfg, caches)
            rcaches = RKV.seal_hot_block_jit(rcfg, rcaches)
            seals += 1
    _tree_close(caches, rcaches, **STATE_TOL)
    if kind == "lsm":
        assert seals >= 1
        assert int(caches["n_blocks"].min()) > cfg.lsm_topk


# -- (d) generate -------------------------------------------------------------

def _ref_step_logits(rcfg, params, batch, tokens, kind):
    """Each step's logits of the reference's `generate`, replayed with its
    own tokens through its prefill and decode loop."""
    lg, caches = _ref_prefill(rcfg, params, batch)
    if kind == "lsm":
        caches = RKV.lsm_from_dense(rcfg, caches, MAX_LEN)
    else:
        grown = RLM.init_decode_caches(rcfg, 2, MAX_LEN)
        caches = dict(caches, **{k: grown[k].at[:, :, :PROMPT].set(
            caches[k]) for k in ("k", "v")})
    out = [np.asarray(lg)]
    for i in range(tokens.shape[1] - 1):
        lg, caches = _ref_decode(rcfg, params, jnp.asarray(tokens[:, i]),
                                 caches, kind)
        out.append(np.asarray(lg))
        if kind == "lsm" and int(caches["hot_len"][0, 0]) >= \
                rcfg.lsm_hot_window:
            caches = RKV.seal_hot_block_jit(rcfg, caches)
    return out


@pytest.mark.parametrize("kind", ["dense", "lsm"])
def test_generate_matches_reference(kind):
    """The port's `generate` against the reference's over an image-grid
    prompt: tokens (or equal up to a near tie), then every cache leaf."""
    cfg, rcfg, params, model = _models(seed=2)
    toks = _tokens(cfg, seed=3)[:, :PROMPT]
    tb, jb = _batches(toks, grid_positions3(2, PROMPT))
    stats = {}
    got, caches = TKV.generate(cfg, model, tb, STEPS, kind, stats=stats)
    want, rcaches = RKV.generate(rcfg, params, jb, STEPS, kind)
    got, want = got.numpy(), np.asarray(want)
    if kind == "lsm":
        assert stats["seals"] >= 1
    if not np.array_equal(got, want):
        first = int(np.argmax((got != want).any(axis=0)))
        np.testing.assert_array_equal(got[:, :first], want[:, :first])
        lg = _ref_step_logits(rcfg, params, jb, want, kind)[first]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        differ = got[:, first] != want[:, first]
        assert ((top2[:, 1] - top2[:, 0])[differ] <= 1e-3).all(), \
            "tokens differ where the reference's top-2 margin exceeds 1e-3"
        return            # past a near tie the two caches follow other tokens
    _tree_close(caches, rcaches, **STATE_TOL)


# -- (e) the converter --------------------------------------------------------

def test_converter_roundtrip():
    cfg, _, params, model = _models(seed=4)
    tree = jax.tree.map(np.asarray, params)
    got = CV.lm_params_to_numpy(model)
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, got, tree)
    assert {"bq", "bk", "bv"} <= set(got["layers"]["attn"])
    assert dataclasses.asdict(cfg)["mrope_sections"] == (4, 2, 2)
