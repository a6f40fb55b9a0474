"""Port parity of the LM serving path (dense and moe families,
sLSM-tiered decode; the ssm and hybrid families are in
`tests/test_torch_ssm.py`, encdec in `test_torch_encdec.py`, vlm in
`test_torch_vlm.py`).

Every check runs the reference (JAX on the CPU, Pallas in interpret
mode) and the port (torch on the CPU, where `decode_attention` runs its
plain version) on the same numpy inputs, at `smoke()` size in f32.
Tolerances: f32 kernel math atol 1e-5 (rtol 1e-4); bf16 one ulp, rtol
8e-3 (2**-7 relative) with atol 1e-4, since both sides sum in f32 and
round once; model logits rtol = atol = 2e-3, the reference suite's own
(`tests/test_models.py`); caches 1e-4.
The CUDA kernel itself is held against the plain version on the card
in `test_torch_gpu.py`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_arch_ids as ref_arch_ids  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.kernels.lsm_attention import ops as RKO  # noqa: E402
from repro.kernels.lsm_attention.lsm_attention import (  # noqa: E402
    decode_attention_pallas)
from repro.kernels.lsm_attention.ref import decode_attention_ref  # noqa: E402
from repro.models import attention as RATT  # noqa: E402
from repro.models import layers as RLY  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.serving import kv_cache as RKV  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import (DENSE_ARCHS, MOE_ARCHS,  # noqa: E402
                                 all_arch_ids, get_config)
from repro_torch.kernels.lsm_attention import ops as TKO  # noqa: E402
from repro_torch.models import attention as TATT  # noqa: E402
from repro_torch.models import layers as TLY  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.serving import kv_cache as TKV  # noqa: E402

ARCHS = [a.replace("_", "-") for a in DENSE_ARCHS + MOE_ARCHS]
PROMPT, STEPS = 96, 64          # smoke: W=64, mu=16, topk=2 -> seals
TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
       "bfloat16": dict(atol=1e-4, rtol=8e-3)}
LOGIT_TOL = dict(atol=2e-3, rtol=2e-3)

_ref_decode = jax.jit(RLM.decode_step, static_argnums=(0, 4))
_ref_prefill = jax.jit(RLM.prefill_step, static_argnums=0)


def _np(x):
    """numpy f32 view of a torch tensor or a jax array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype):
    """One numpy array as a jax array and a torch tensor of `dtype`."""
    j = jnp.asarray(a, jnp.dtype(dtype))
    return j, torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# -- (a) the kernel's plain version -------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [16, 64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_decode_attention_plain_matches_pallas(group, dh, dtype):
    """Ragged bitmap with one all-invalid (batch, kv-head) row against
    the Pallas kernel; prefix validity against the jnp reference."""
    rng = np.random.default_rng(group * 1000 + dh)
    b, kv, length = 2, (2 if group < 4 else 1), 512
    h = group * kv
    q, tq = _pair(rng.normal(size=(b, h, dh)), dtype)
    k, tk = _pair(rng.normal(size=(b, length, kv, dh)), dtype)
    v, tv = _pair(rng.normal(size=(b, length, kv, dh)), dtype)
    valid = (rng.random((b, kv, length)) < 0.6).astype(np.int8)
    valid[1, 0] = 0                                      # no valid position
    scale = dh ** -0.5
    got = TKO.decode_attention(tq, tk, tv, torch.from_numpy(valid), scale)
    assert got.dtype == tq.dtype and got.shape == (b, h, dh)
    want = decode_attention_pallas(q, k, v, jnp.asarray(valid), scale,
                                   interpret=True)
    _close(got, want, **TOL[dtype])
    assert not _np(got)[1, :group].any()                 # empty row -> 0
    lengths = np.array([300, length], np.int32)
    got = TKO.decode_attention_op(tq, tk, tv, torch.from_numpy(lengths),
                                  scale)
    _close(got, decode_attention_ref(q, k, v, jnp.asarray(lengths), scale),
           **TOL[dtype])


@pytest.mark.parametrize("length", [1, 100, 700])
def test_decode_attention_op_any_length(length):
    """The port takes any L; the reference pads to a multiple of 512."""
    rng = np.random.default_rng(length)
    b, h, kv, dh = 2, 4, 2, 16
    q, tq = _pair(rng.normal(size=(b, h, dh)), "float32")
    k, tk = _pair(rng.normal(size=(b, length, kv, dh)), "float32")
    v, tv = _pair(rng.normal(size=(b, length, kv, dh)), "float32")
    lengths = np.array([max(1, length // 3), length], np.int32)
    got = TKO.decode_attention_op(tq, tk, tv, torch.from_numpy(lengths),
                                  dh ** -0.5)
    want = RKO.decode_attention_op(q, k, v, jnp.asarray(lengths), dh ** -0.5)
    _close(got, want, **TOL["float32"])


# -- (b) block selection and the tiered op ------------------------------------

@pytest.mark.parametrize("group,dtype,n_blocks,topk", [
    (2, "float32", (5, 1), 2),      # row 1 has fewer blocks than topk
    (1, "bfloat16", (8, 3), 3),
    (4, "float32", (0, 2), 2),      # row 0 has no cold block at all
    (2, "bfloat16", (6, 6), 4),
])
def test_select_blocks_and_tiered_op_match(group, dtype, n_blocks, topk):
    rng = np.random.default_rng(topk * 10 + group)
    b, kv, dh, w, nb, mu = 2, 2, 16, 64, 8, 16
    h = group * kv
    q, tq = _pair(rng.normal(size=(b, h, dh)), dtype)
    hk, thk = _pair(rng.normal(size=(b, w, kv, dh)), dtype)
    hv, thv = _pair(rng.normal(size=(b, w, kv, dh)), dtype)
    bk, tbk = _pair(rng.normal(size=(b, nb, mu, kv, dh)), dtype)
    bv, tbv = _pair(rng.normal(size=(b, nb, mu, kv, dh)), dtype)
    sm, tsm = _pair(np.asarray(_np(tbk)).mean(axis=2), dtype)
    nbk = np.array(n_blocks, np.int32)
    hot_len = np.array([w, 17], np.int32)
    ids, ok = TKO.select_blocks(tq, tsm, torch.from_numpy(nbk), topk)
    rids, rok = RKO.select_blocks(q, sm, jnp.asarray(nbk), topk)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    np.testing.assert_array_equal(ids.numpy()[ok.numpy()],
                                  np.asarray(rids)[np.asarray(rok)])
    got = TKO.lsm_decode_attention_op(
        tq, thk, thv, torch.from_numpy(hot_len), tbk, tbv, tsm,
        torch.from_numpy(nbk), topk, dh ** -0.5)
    want = RKO.lsm_decode_attention_op(q, hk, hv, jnp.asarray(hot_len), bk,
                                       bv, sm, jnp.asarray(nbk), topk,
                                       dh ** -0.5)
    _close(got, want, **TOL[dtype])


@pytest.mark.parametrize("group,dtype,n_blocks,topk", [
    (2, "float32", (5, 1), 2),      # row 1 has fewer blocks than topk
    (1, "bfloat16", (8, 3), 3),
    (4, "float32", (0, 2), 2),      # row 0 has no cold block at all
    (3, "bfloat16", (6, 6), 4),
])
def test_tiered_plain_never_reads_invalid_rows(group, dtype, n_blocks, topk):
    """The tiered entry point's plain path (the one the model runs on the
    CPU) with every row it must not read set to NaN — hot rows at or past
    hot_len, blocks at or past n_blocks — against the reference on the
    same cache with those rows finite: a finite output within the
    tolerance, so no such row reached it."""
    rng = np.random.default_rng(topk * 100 + group)
    b, kv, dh, w, nb, mu = 2, 2, 16, 64, 8, 16
    h = group * kv
    hot_len = np.array([w, 9], np.int32)
    nbk = np.array(n_blocks, np.int32)
    arrs = dict(q=rng.normal(size=(b, h, dh)),
                hk=rng.normal(size=(b, w, kv, dh)),
                hv=rng.normal(size=(b, w, kv, dh)),
                bk=rng.normal(size=(b, nb, mu, kv, dh)),
                bv=rng.normal(size=(b, nb, mu, kv, dh)))
    arrs["sm"] = arrs["bk"].mean(axis=2)
    ref = {n: _pair(a, dtype)[0] for n, a in arrs.items()}
    poisoned = {n: a.copy() for n, a in arrs.items()}
    for r in range(b):
        poisoned["hk"][r, hot_len[r]:] = np.nan
        poisoned["hv"][r, hot_len[r]:] = np.nan
        poisoned["bk"][r, nbk[r]:] = np.nan
        poisoned["bv"][r, nbk[r]:] = np.nan
    t = {n: _pair(a, dtype)[1] for n, a in poisoned.items()}
    t["sm"] = _pair(arrs["sm"], dtype)[1]
    ids, ok = TKO.select_blocks(t["q"], t["sm"], torch.from_numpy(nbk), topk)
    got = TKO.lsm_decode_attention(t["q"], t["hk"], t["hv"],
                                   torch.from_numpy(hot_len), t["bk"],
                                   t["bv"], ids, ok, dh ** -0.5)
    assert got.dtype == t["q"].dtype and torch.isfinite(got).all()
    want = RKO.lsm_decode_attention_op(ref["q"], ref["hk"], ref["hv"],
                                       jnp.asarray(hot_len), ref["bk"],
                                       ref["bv"], ref["sm"],
                                       jnp.asarray(nbk), topk, dh ** -0.5)
    _close(got, want, **TOL[dtype])
    op = TKO.lsm_decode_attention_op(t["q"], t["hk"], t["hv"],
                                     torch.from_numpy(hot_len), t["bk"],
                                     t["bv"], t["sm"], torch.from_numpy(nbk),
                                     topk, dh ** -0.5)
    assert torch.equal(op, got)


# -- layers, prefill attention, configs ---------------------------------------

def test_configs_match_reference():
    """Every registered architecture, at full size and at smoke(); the
    reference's aliases name the same configuration in the port."""
    for arch in all_arch_ids() + ["whisper-tiny", "qwen2-vl-7b",
                                  "phi4-mini-3.8b", "qwen1.5-4b"]:
        for f in (lambda c: c, lambda c: c.smoke()):
            assert (dataclasses.asdict(f(get_config(arch)))
                    == dataclasses.asdict(f(ref_config(arch))))


def test_all_arch_ids_match_reference():
    """The port runs every architecture the reference registers."""
    assert set(all_arch_ids()) == set(ref_arch_ids())
    assert len(all_arch_ids()) == len(ref_arch_ids())


@pytest.mark.parametrize("field,value,error", [
    ("family", "rnn", NotImplementedError), ("act", "relu", ValueError),
    ("norm", "batchnorm", ValueError)])
def test_check_supported_raises_for_an_unknown_family_act_or_norm(
        field, value, error):
    cfg = dataclasses.replace(get_config("gemma-7b").smoke(),
                              **{field: value})
    with pytest.raises(error, match=value):
        TLM.init_params(cfg, 0, device="cpu")
    with pytest.raises(error, match=value):
        TLM.init_decode_caches(cfg, 2, 16, device="cpu")


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_norm_rope_mlp_match_reference(act):
    cfg = dataclasses.replace(get_config("gemma-7b").smoke(), act=act)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=cfg.d_model).astype(np.float32)
    _close(TLY.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           RLY.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6), atol=1e-6,
           rtol=1e-6)
    xh = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5], [7, 9, 11, 400, 4096, 20000]])
    _close(TLY.apply_rope(torch.from_numpy(xh), torch.from_numpy(pos), 1e4),
           RLY.apply_rope(jnp.asarray(xh), jnp.asarray(pos), 1e4),
           atol=1e-5, rtol=1e-5)
    p = RLY.init_mlp(dataclasses.replace(cfg, dtype="float32"),
                     jax.random.PRNGKey(3))
    mlp = TLY.MLP(cfg, "cpu", torch.float32)
    with torch.no_grad():
        for name, a in p.items():
            getattr(mlp, name).weight.copy_(torch.tensor(np.asarray(a).T))
        got = mlp(torch.from_numpy(x))
    _close(got, RLY.mlp(cfg, p, jnp.asarray(x)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,q_offset,sq", [(True, 0, 48), (False, 0, 48),
                                                (True, 32, 16)])
def test_flash_attention_matches_reference(causal, q_offset, sq):
    rng = np.random.default_rng(sq + q_offset)
    q = rng.normal(size=(2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 48, 4, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, q_chunk=16, k_chunk=16, q_offset=q_offset)
    got = TATT.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               **kw)
    want = RATT.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    _close(got, want, atol=1e-5, rtol=1e-5)


# -- the model: weights and caches carried across -----------------------------

def _models(arch, seed=1):
    cfg, rcfg = get_config(arch).smoke(), ref_config(arch).smoke()
    params = RLM.init_params(rcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return cfg, rcfg, params, CV.lm_params_from_numpy(cfg, tree, "cpu")


def _tokens(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (2, PROMPT + STEPS)).astype(np.int32)


def _ref_grown(rcfg, caches, max_len):
    """The reference's `generate` cache growth for kind dense."""
    b, s = caches["k"].shape[1:3]
    grown = RLM.init_decode_caches(rcfg, b, max_len, kind="dense")
    for kk in ("k", "v"):
        grown[kk] = grown[kk].at[:, :, :s].set(caches[kk])
    grown["pos"] = caches["pos"]
    return grown


# -- (c) prefill and teacher-forced decode ------------------------------------

@pytest.mark.parametrize("kind", ["dense", "lsm"])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_reference(arch, kind):
    cfg, rcfg, params, model = _models(arch)
    toks = _tokens(cfg)
    max_len = PROMPT + STEPS + 8
    full = RLM.logits_full(rcfg, params, {"tokens": jnp.asarray(toks)})[0]
    prompt = {"tokens": toks[:, :PROMPT]}
    lg, caches = TLM.prefill_step(cfg, model, prompt)
    rlg, rcaches = _ref_prefill(rcfg, params,
                                {"tokens": jnp.asarray(prompt["tokens"])})
    _close(lg, rlg, **LOGIT_TOL)
    _close(lg, full[:, PROMPT - 1], **LOGIT_TOL)
    for kk in ("k", "v"):
        _close(caches[kk], rcaches[kk], atol=1e-4, rtol=1e-4)
    # both packages decode from one state: the reference's, carried over
    rcaches = (RKV.lsm_from_dense(rcfg, rcaches, max_len) if kind == "lsm"
               else _ref_grown(rcfg, rcaches, max_len))
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
            assert int(caches["hot_len"][0, 0]) == rcfg.lsm_hot_window
            caches = TKV.seal_hot_block(cfg, caches)
            rcaches = RKV.seal_hot_block_jit(rcfg, rcaches)
            seals += 1
    if kind == "lsm":
        assert seals >= 1
        assert int(caches["n_blocks"].min()) > cfg.lsm_topk
        np.testing.assert_array_equal(caches["n_blocks"].numpy(),
                                      np.asarray(rcaches["n_blocks"]))


# -- (d) generate -------------------------------------------------------------

def _ref_margins(rcfg, params, prompt, tokens, kind, max_len):
    """Top-2 logit margin of each step of the reference's `generate`,
    replayed with its own tokens."""
    lg, caches = _ref_prefill(rcfg, params, {"tokens": jnp.asarray(prompt)})
    caches = (RKV.lsm_from_dense(rcfg, caches, max_len) if kind == "lsm"
              else _ref_grown(rcfg, caches, max_len))
    margins = []
    for i in range(tokens.shape[1]):
        top2 = np.sort(np.asarray(lg), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        if i + 1 == tokens.shape[1]:
            break
        lg, caches = _ref_decode(rcfg, params, jnp.asarray(tokens[:, i]),
                                 caches, kind)
        if kind == "lsm" and int(caches["hot_len"][0, 0]) >= \
                rcfg.lsm_hot_window:
            caches = RKV.seal_hot_block_jit(rcfg, caches)
    return np.stack(margins, axis=1)


@pytest.mark.parametrize("arch,kind", [(a, "lsm") for a in ARCHS]
                         + [("phi4-mini-3.8b", "dense")])
def test_generate_matches_reference(arch, kind):
    cfg, rcfg, params, model = _models(arch, seed=2)
    prompt = _tokens(cfg, seed=3)[:, :PROMPT]
    stats = {}
    toks, caches = TKV.generate(cfg, model, {"tokens": prompt}, STEPS, kind,
                                stats=stats)
    rtoks, rcaches = RKV.generate(rcfg, params,
                                  {"tokens": jnp.asarray(prompt)}, STEPS,
                                  kind)
    toks, rtoks = toks.numpy(), np.asarray(rtoks)
    if not np.array_equal(toks, rtoks):
        margins = _ref_margins(rcfg, params, prompt, rtoks, kind,
                               PROMPT + STEPS + 8)
        first = int(np.argmax((toks != rtoks).any(axis=0)))
        np.testing.assert_array_equal(toks[:, :first], rtoks[:, :first])
        differ = toks[:, first] != rtoks[:, first]
        assert (margins[differ, first] <= 1e-3).all(), \
            "tokens differ where the reference's top-2 margin exceeds 1e-3"
        return            # past a near tie the two caches follow other tokens
    for kk, want in rcaches.items():
        if want.dtype == jnp.int32:
            np.testing.assert_array_equal(caches[kk].numpy(),
                                          np.asarray(want))
        else:
            _close(caches[kk], want, atol=1e-4, rtol=1e-4)
    if kind == "lsm":
        assert stats["seals"] >= 1
        assert int(caches["n_blocks"].min()) > cfg.lsm_topk


# -- (e) the converter --------------------------------------------------------

def _tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("case", ["roundtrip", "transposed_raises",
                                  "square_transpose_caught", "missing_leaf",
                                  "caches_roundtrip"])
def test_lm_converter(case):
    arch = "qwen1.5-4b"                                # has q/k/v biases
    cfg, rcfg, params, model = _models(arch, seed=4)
    tree = jax.tree.map(np.asarray, params)
    if case == "roundtrip":
        _tree_equal(CV.lm_params_to_numpy(model), tree)
    elif case == "transposed_raises":      # (d, f) stored as (f, d)
        tree["layers"]["mlp"]["w_up"] = np.swapaxes(
            tree["layers"]["mlp"]["w_up"], 1, 2)
        with pytest.raises(ValueError, match="w_up"):
            CV.lm_params_from_numpy(cfg, tree, "cpu")
    elif case == "square_transpose_caught":
        # wq is (64, 64) at smoke size: no shape tells its orientation,
        # the logits do
        toks = _tokens(cfg)[:, :16]
        want = RLM.logits_full(rcfg, params, {"tokens": jnp.asarray(toks)})[0]
        _close(TLM.logits_full(cfg, model, {"tokens": toks}), want,
               **LOGIT_TOL)
        tree["layers"]["attn"]["wq"] = np.swapaxes(
            tree["layers"]["attn"]["wq"], 1, 2)
        bad = CV.lm_params_from_numpy(cfg, tree, "cpu")
        with pytest.raises(AssertionError):
            _close(TLM.logits_full(cfg, bad, {"tokens": toks}), want,
                   **LOGIT_TOL)
    elif case == "missing_leaf":
        del tree["layers"]["attn"]["bk"]
        with pytest.raises(KeyError, match="bk"):
            CV.lm_params_from_numpy(cfg, tree, "cpu")
    else:
        rng = np.random.default_rng(5)
        for kind in ("dense", "lsm"):
            ref = jax.tree.map(np.asarray, RLM.init_decode_caches(
                rcfg, 2, 40, kind=kind))
            ref = {k: (rng.normal(size=a.shape).astype(a.dtype)
                       if a.dtype == np.float32
                       else rng.integers(0, 9, a.shape).astype(a.dtype))
                   for k, a in ref.items()}
            port = CV.caches_from_numpy(ref, "cpu")
            shapes = TATT.lsm_cache_shapes(cfg, 2, 40)
            if kind == "lsm":
                assert all(tuple(port[k].shape[1:]) == s
                           for k, (s, _) in shapes.items())
            _tree_equal(CV.caches_to_numpy(port), ref)


# -- what the port refuses ----------------------------------------------------

def test_decode_refuses_out_of_range_writes():
    cfg, _, _, model = _models("phi4-mini-3.8b")
    prompt = _tokens(cfg)[:, :PROMPT]
    _, dense = TLM.prefill_step(cfg, model, {"tokens": prompt})
    lsm = TKV.lsm_from_dense(cfg, dense, PROMPT + 8)
    tok = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(IndexError, match="outside the dense cache"):
        TLM.decode_step(cfg, model, tok, dense, "dense")  # cache == prompt
    full = dict(lsm, hot_len=torch.full_like(lsm["hot_len"],
                                             cfg.lsm_hot_window))
    with pytest.raises(IndexError, match="seal first"):
        TLM.decode_step(cfg, model, tok, full, "lsm")
    no_room = dict(lsm, n_blocks=torch.full_like(lsm["n_blocks"],
                                                 lsm["blk_k"].shape[2]))
    with pytest.raises(IndexError, match="free cold block"):
        TKV.seal_hot_block(cfg, no_room)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TLM.init_params(cfg, 0)


# -- grouped block selection (lsm_dp_groups > 1) -----------------------------

@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_block_selection_matches_ungrouped_and_reference(
        groups, monkeypatch):
    """The port of `tests/test_perf_opts.py::test_grouped_lsm_selection_exact`:
    one tiered decode step of the DeepSeek smoke model (topk 2, more
    sealed blocks than that) with `lsm_dp_groups` G against G = 1 at
    1e-5, and against the reference's grouped step at the logit
    tolerance, from the reference's own caches. The kernel's plain
    version gets all G * topk candidates, masked by `ok`."""
    cfg = dataclasses.replace(get_config("deepseek-7b").smoke(),
                              lsm_dp_groups=1, lsm_topk=2)
    rcfg = dataclasses.replace(ref_config("deepseek-7b").smoke(),
                               lsm_dp_groups=1, lsm_topk=2)
    params = RLM.init_params(rcfg, jax.random.PRNGKey(0))
    model = CV.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                    "cpu")
    toks = _tokens(cfg)[:, :PROMPT + 1]
    _, dense = _ref_prefill(rcfg, params, {"tokens": toks[:, :PROMPT]})
    lsm = jax.tree.map(np.asarray, RKV.lsm_from_dense(rcfg, dense,
                                                      PROMPT + 16))
    assert (lsm["n_blocks"] > cfg.lsm_topk).all()
    rgrouped = dataclasses.replace(rcfg, lsm_dp_groups=groups)
    want, _ = _ref_decode(rgrouped, params, jnp.asarray(toks[:, PROMPT]),
                          jax.tree.map(jnp.asarray, lsm), "lsm")
    candidates = []
    plain = TKO.lsm_decode_attention

    def spy(q, hot_k, hot_v, hot_len, blk_k, blk_v, ids, ok, scale):
        candidates.append(ids.shape[-1])
        return plain(q, hot_k, hot_v, hot_len, blk_k, blk_v, ids, ok, scale)

    monkeypatch.setattr(TKO, "lsm_decode_attention", spy)
    tok = torch.from_numpy(toks[:, PROMPT])
    one, _ = TLM.decode_step(cfg, model, tok,
                             CV.caches_from_numpy(lsm, "cpu"), "lsm")
    got, _ = TLM.decode_step(dataclasses.replace(cfg, lsm_dp_groups=groups),
                             model, tok, CV.caches_from_numpy(lsm, "cpu"),
                             "lsm")
    n = cfg.n_layers
    assert candidates == [cfg.lsm_topk] * n + [groups * cfg.lsm_topk] * n
    _close(got, one, rtol=1e-5, atol=1e-5)
    _close(got, want, **LOGIT_TOL)


def test_param_count_matches_reference():
    """`lm.param_count` of every architecture's smoke model, its
    vocabulary cut to 500 (padded to 512), counts the reference tree's
    elements, the padding included."""
    for arch in all_arch_ids():
        cfg = dataclasses.replace(get_config(arch).smoke(), vocab=500)
        rcfg = dataclasses.replace(ref_config(arch).smoke(), vocab=500)
        shapes = jax.eval_shape(
            lambda: RLM.init_params(rcfg, jax.random.PRNGKey(0)))
        model = TLM.init_params(cfg, 0, device="cpu")
        assert TLM.param_count(model) == RLM.param_count(shapes), arch
        assert TLM.param_count(dict(model.named_parameters())) \
            == TLM.param_count(model)
        assert model.embed.shape[0] == cfg.padded_vocab > cfg.vocab
