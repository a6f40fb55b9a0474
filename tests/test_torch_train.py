"""Port parity of the training path: `data.TokenStream`,
`train.loss.chunked_cross_entropy`, `train.optimizer` (the cosine
schedule, global-norm clipping, AdamW) and `train.train_step`
(`make_train_step`, `make_eval_step`), with the backward of every
family's `lm.forward`, against the reference on the same numpy inputs,
at `smoke()` size in f32 (JAX on the CPU, torch on the CPU).

Tolerances:
- TokenStream bitwise.
- The loss, aux, grad norm, lr and the cross-entropy's value and
  gradients rtol 1e-5 (f32 sums in another order).
- A model's gradients rtol 1e-4, atol 1e-6 times the leaf's largest
  |gradient| where that exceeds 1: a smoke model's embedding gradient
  reaches 2-6 (the 0.02 embedding scale under RMSNorm), and its entries
  near zero, left by cancellation, differ by a few ulps of that scale
  (DeepSeek: 1.77e-6 at an entry of 0.007). For the ssm and hybrid
  families, whose gradients pass through the chunked SSD, rtol 1e-4 with
  atol 1e-4 of the leaf's largest |gradient|: the SSD's own rule in
  `tests/test_torch_ssm.py` (its segsum subtracts cumulative sums of
  dt * A that reach ~-300 within a chunk, where an f32 ulp is 3e-5, so
  its error follows the size of a value, not of each element). Measured:
  at most 6e-5 of a leaf's largest gradient (A_log), and 1.26e-5
  absolute in an embedding gradient of largest 4.3 (Zamba2), where
  atol 1e-6 would fail. The chunked SSD's and the moe FFN's own
  gradients are held to the same SSD rule.
- Updated parameters within 2 * lr + 1e-6: Adam's first step turns each
  gradient entry into about +-1 (m / sqrt(v) = g / |g|), so an entry
  whose gradient is nearly zero may flip its sign between the packages
  and move its parameter by up to 2 * lr. From equal weights two first
  steps differ by at most that much whatever their gradients, so this
  bound only catches a step that is missing, not finite or at another
  lr: the gradients above, from `value_and_grad` and from the step's
  own first moment, are what hold the backward.
"""
import copy
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import TokenStream as RefTokenStream  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models import ssm as RSSM  # noqa: E402
from repro.train import loss as RLOSS  # noqa: E402
from repro.train import optimizer as ROPT  # noqa: E402
from repro.train import train_step as RTS  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.serving import grow_dense  # noqa: E402
from repro_torch.train import (adamw_init, adamw_update,  # noqa: E402
                               chunked_cross_entropy, make_train_step)
from repro_torch.train import optimizer as TOPT  # noqa: E402
from repro_torch.train import train_step as TTS  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FAMILY_ARCHS = ["deepseek-7b", "granite-moe-1b-a400m", "mamba2-370m",
                "zamba2-1.2b", "whisper-tiny", "qwen2-vl-7b"]
SCALAR_TOL = dict(rtol=1e-5, atol=0)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
OWN_REL = 1e-4                  # gradients through the chunked SSD
LR, WARMUP = 1e-3, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these smoke-size tensors: more threads cost
    more than they save at this size, and in a suite of parallel workers
    they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _own_close(got, want, what=""):
    """The SSD rule: OWN_REL relative plus OWN_REL of the largest |want|."""
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=OWN_REL,
                               atol=OWN_REL * float(np.abs(w).max()),
                               err_msg=what)


def _grad_close(cfg, got, want, what):
    if cfg.family in ("ssm", "hybrid"):
        _own_close(got, want, what)
    else:
        w = _np(want)
        atol = GRAD_ATOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(_np(got), w, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=what)


def _batch(cfg, seed=0, b=2, s=16):
    """The reference suite's batch (`tests/test_models.py`) with pad
    labels; vlm with distinct (t, h, w) position streams."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[:, -3:] = -1
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": labels}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        t = np.arange(s)
        batch["positions3"] = np.broadcast_to(
            np.stack([t, t // 4, t % 4])[:, None], (3, b, s)).astype(np.int32)
    return batch


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_hosts", [(0, 1), (3, 2), (7, 4)])
def test_token_stream_bitwise(seed, n_hosts):
    """Each host's slice, step after step, bit for bit the reference's;
    hosts draw different slices."""
    firsts = []
    for host in range(n_hosts):
        got = TokenStream(1000, 8, 16, seed=seed, host_id=host,
                          n_hosts=n_hosts)
        want = RefTokenStream(1000, 8, 16, seed=seed, host_id=host,
                              n_hosts=n_hosts)
        for _ in range(3):
            g, w = next(got), next(want)
            assert set(g) == set(w) == {"tokens", "labels"}
            for k in g:
                assert g[k].dtype == w[k].dtype == np.int32
                np.testing.assert_array_equal(g[k], w[k])
            assert g["tokens"].shape == (8 // n_hosts, 16)
        firsts.append(g["tokens"])
    assert all(not (a == firsts[0]).all() for a in firsts[1:])
    with pytest.raises(ValueError):
        TokenStream(1000, 6, 16, n_hosts=4)


# -- loss ---------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(12, 4), (12, 5), (16, 512)])
def test_chunked_cross_entropy_value_and_grads(s, chunk):
    """Value and gradients w.r.t. hidden and lm_head against
    `jax.value_and_grad`, with pad labels (-1, one row all pad) and a
    padded vocabulary (500 of 512 columns)."""
    rng = np.random.default_rng(s + chunk)
    b, d, vocab, vp = 3, 24, 500, 512
    hidden = rng.normal(size=(b, s, d)).astype(np.float32)
    head = (rng.normal(size=(d, vp)) * d ** -0.5).astype(np.float32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, ::3] = -1
    labels[2] = -1

    def ref(h, w):
        return RLOSS.chunked_cross_entropy(h, w, jnp.asarray(labels), vocab,
                                           chunk)
    want, (wh, ww) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(head))
    h = torch.from_numpy(hidden).requires_grad_(True)
    w = torch.from_numpy(head).requires_grad_(True)
    got = chunked_cross_entropy(h, w, torch.from_numpy(labels), vocab, chunk)
    gh, gw = torch.autograd.grad(got, (h, w))
    got = got.detach()
    np.testing.assert_allclose(float(got), float(want), **SCALAR_TOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gw.numpy(), np.asarray(ww), rtol=1e-5,
                               atol=1e-7)
    assert not gw[:, vocab:].any()       # padded columns get no gradient
    with torch.no_grad():                # no checkpoint without autograd
        again = chunked_cross_entropy(h, w, torch.from_numpy(labels), vocab,
                                      chunk)
    assert float(again) == float(got)


# -- optimizer ----------------------------------------------------------------

def test_cosine_schedule_and_clipping_match_reference():
    ref = ROPT.cosine_schedule(3e-4, 10, 100)
    got = TOPT.cosine_schedule(3e-4, 10, 100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        assert float(got(torch.tensor(step, dtype=torch.int32))) \
            == pytest.approx(float(ref(jnp.asarray(step, jnp.int32))),
                             rel=1e-6)
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(4, 5)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32) * 3}
    t = {k: torch.from_numpy(v) for k, v in tree.items()}
    j = {k: jnp.asarray(v) for k, v in tree.items()}
    np.testing.assert_allclose(float(TOPT.global_norm(t)),
                               float(ROPT.global_norm(j)), **SCALAR_TOL)
    for max_norm in (0.5, 100.0):
        got, gn = TOPT.clip_by_global_norm(t, max_norm)
        want, wn = ROPT.clip_by_global_norm(j, max_norm)
        np.testing.assert_allclose(float(gn), float(wn), **SCALAR_TOL)
        for k in tree:
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6)


def test_adamw_three_steps_on_a_mixed_tree():
    """Three updates of a bf16/f32 tree (a bf16 matrix, an f32 vector, an
    f32 scalar), clipped and not: f32 moments for every leaf, each
    update in f32 cast back to the leaf's dtype, as the reference's; the
    bf16 leaves within one bf16 ulp, the rest at 1e-6."""
    rng = np.random.default_rng(2)
    leaves = {"w": (rng.normal(size=(8, 6)), "bfloat16"),
              "b": (rng.normal(size=(6,)), "float32"),
              "s": (rng.normal(size=()), "float32")}
    jp = {k: jnp.asarray(v, jnp.dtype(dt)) for k, (v, dt) in leaves.items()}
    tp = {k: torch.tensor(np.asarray(v, np.float32)).to(getattr(torch, dt))
          for k, (v, dt) in leaves.items()}
    lr_fn = ROPT.cosine_schedule(1e-2, 2, 10)
    tlr = TOPT.cosine_schedule(1e-2, 2, 10)
    jstate, tstate = ROPT.adamw_init(jp), adamw_init(tp)
    assert all(m.dtype == torch.float32 for m in tstate.mu.values())
    for i in range(3):
        g = {k: rng.normal(size=np.shape(v)) * (i + 1)
             for k, (v, _) in leaves.items()}
        jg = {k: jnp.asarray(v, jp[k].dtype) for k, v in g.items()}
        tg = {k: torch.tensor(np.asarray(v, np.float32)).to(tp[k].dtype)
              for k, v in g.items()}
        if i == 1:           # clipped: the scale folded into the update
            jg, _ = ROPT.clip_by_global_norm(jg, 0.5)
            scale = TOPT.clip_scale(TOPT.global_norm(tg), 0.5)
        else:
            scale = None
        jp, jstate = ROPT.adamw_update(jg, jstate, jp, lr_fn)
        tp, tstate = adamw_update(tg, tstate, tp, tlr, grad_scale=scale)
        assert int(tstate.step) == int(jstate.step) == i + 1
        for k in leaves:
            assert tp[k].dtype == getattr(torch, leaves[k][1])
            want = np.asarray(jp[k].astype(jnp.float32))
            tol = (dict(rtol=2 ** -8, atol=0) if leaves[k][1] == "bfloat16"
                   else dict(rtol=1e-6, atol=1e-7))
            np.testing.assert_allclose(_np(tp[k]), want, **tol)
            np.testing.assert_allclose(tstate.mu[k].numpy(),
                                       np.asarray(jstate.mu[k]), rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_allclose(tstate.nu[k].numpy(),
                                       np.asarray(jstate.nu[k]), rtol=1e-5,
                                       atol=1e-7)


# -- the backward of the SSD and the moe FFN ----------------------------------

@pytest.mark.parametrize("case", ["chunks", "h0_groups2"])
def test_ssd_chunked_gradients_match_reference(case):
    """Gradients of a weighted sum of (y, h_final) w.r.t. every SSD input
    over several chunks (the inter-chunk scan), with an initial state
    and two B/C groups in the second case."""
    rng = np.random.default_rng(5)
    b, s, h, p, n, chunk = 2, 48, 4, 8, 8, 16
    g = 2 if case == "h0_groups2" else 1
    ins = [rng.normal(size=(b, s, h, p)),
           np.log1p(np.exp(rng.normal(size=(b, s, h)))),
           -np.linspace(1.0, 16.0, h),
           rng.normal(size=(b, s, g, n)), rng.normal(size=(b, s, g, n))]
    if case == "h0_groups2":
        ins.append(rng.normal(size=(b, h, p, n)))
    ins = [np.asarray(a, np.float32) for a in ins]
    wy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    wh = rng.normal(size=(b, h, p, n)).astype(np.float32)

    def ref(*a):
        y, hl = RSSM.ssd_chunked(*a[:5], chunk=chunk,
                                 h0=a[5] if len(a) > 5 else None)
        return jnp.sum(y * wy) + jnp.sum(hl * wh)
    want = jax.jit(jax.grad(ref, argnums=tuple(range(len(ins)))))(
        *(jnp.asarray(a) for a in ins))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y, hl = TSSM.ssd_chunked(*ts[:5], chunk=chunk,
                             h0=ts[5] if len(ts) > 5 else None)
    got = torch.autograd.grad((y * torch.from_numpy(wy)).sum()
                              + (hl * torch.from_numpy(wh)).sum(), ts)
    for gt, wt in zip(got, want):
        assert torch.isfinite(gt).all()
        _own_close(gt, wt)


@pytest.mark.parametrize("groups,factor", [(1, 0.5), (2, None)])
def test_moe_ffn_gradients_match_reference(groups, factor):
    """Gradients of a weighted sum of y plus aux w.r.t. x, the router and
    the experts (sort, capacity slots, the `index_add_` combine) with
    capacity drops, and with two token groups (one group without drops
    is the Granite smoke model's own, in
    `test_train_step_matches_reference`)."""
    over = {"moe_dp_groups": groups}
    if factor is not None:
        over["capacity_factor"] = factor
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").smoke(),
                              **over)
    rcfg = dataclasses.replace(ref_config("granite-moe-1b-a400m").smoke(),
                               **over)
    p = jax.jit(RMOE.init_moe, static_argnums=0)(rcfg,
                                                 jax.random.PRNGKey(11))
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    wy = rng.normal(size=x.shape).astype(np.float32)

    def ref(p, x):
        y, aux = RMOE.moe_ffn(rcfg, p, x)
        return jnp.sum(y * wy) + 3.0 * aux
    wp, wx = jax.jit(jax.grad(ref, argnums=(0, 1)))(p, jnp.asarray(x))
    moe = TMOE.MoE(cfg, "cpu", torch.float32)
    with torch.no_grad():
        for name, a in p.items():
            getattr(moe, name).copy_(torch.from_numpy(np.array(a)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = TMOE.moe_ffn(cfg, moe, xt)
    names = sorted(p)
    got = torch.autograd.grad((y * torch.from_numpy(wy)).sum() + 3.0 * aux,
                              [xt] + [getattr(moe, n) for n in names])
    _own_close(got[0], wx)
    for n, gt in zip(names, got[1:]):
        _own_close(gt, wp[n])
    assert got[names.index("router") + 1].abs().max() > 0


# -- the train step, family by family -----------------------------------------

# XLA's CPU backend without its LLVM optimisations: the same HLO, compiled
# in about three quarters of the time, which is most of a smoke step's
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _ref_step(rcfg, tree, batch):
    """The reference's `make_train_step` step from the weights `tree`, in
    one jit: -> (new weights, new AdamW state, metrics)."""
    params = jax.tree.map(jnp.asarray, tree)
    step = RTS.make_train_step(rcfg, base_lr=LR, warmup=WARMUP)
    run = jax.jit(lambda p: step(p, ROPT.adamw_init(p), batch))
    return run.lower(params).compile(FAST_COMPILE)(params)


def _grads_from_mu(cfg, mu, grad_norm):
    """The gradients a first step took, read off its first moment: from
    zero moments AdamW's mu is (1 - b1) * clip scale * g, where g is
    `jax.value_and_grad` of the loss (the reference's `grad_fn`, built
    from `repro.models.lm.forward` and `repro.train.loss`) and the clip
    scale is min(1, 1 / grad norm) at grad_clip 1. -> {name: g} in the
    port's parameter names."""
    scale = 0.1 * min(1.0, 1.0 / max(float(grad_norm), 1e-9))
    return dict(CV.lm_params_from_numpy(
        cfg, jax.tree.map(lambda m: np.asarray(m, np.float64) / scale, mu),
        "cpu").named_parameters())


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_step_matches_reference(arch):
    """One `make_train_step` step of each family's smoke model from the
    port's seeded weights, converted for the reference: loss, aux, grad norm and lr at 1e-5; every
    parameter's gradient, from `value_and_grad` and from the step's own
    first moment; every updated parameter within 2 * lr + 1e-6; the eval
    step's loss against the step's cross-entropy at 1e-5 (the
    reference's `make_eval_step` is that same expression)."""
    cfg, rcfg = get_config(arch).smoke(), ref_config(arch).smoke()
    batch = _batch(cfg)
    model = TLM.init_params(cfg, 0, device="cpu")
    tree = jax.tree.map(np.copy, CV.lm_params_to_numpy(model))  # no view
    new_params, rstate, metrics = _ref_step(
        rcfg, tree, {k: jnp.asarray(v) for k, v in batch.items()})
    want = _grads_from_mu(cfg, rstate.mu, metrics["grad_norm"])

    eval_loss = TTS.make_eval_step(cfg)(model, batch)
    np.testing.assert_allclose(float(eval_loss), float(metrics["loss"]),
                               **SCALAR_TOL)
    _, ce, aux, got = TTS.value_and_grad(cfg, model, batch)
    assert set(got) == set(want)
    for name, w in want.items():
        _grad_close(cfg, got[name], w, name)
    assert not any(p.requires_grad for p in model.parameters())

    step = make_train_step(cfg, base_lr=LR, warmup=WARMUP)
    model, state, m = step(model, adamw_init(model), batch)
    assert int(state.step) == 1
    for key in ("loss", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(metrics[key]),
                                   **SCALAR_TOL, err_msg=key)
    np.testing.assert_allclose(float(m["loss"]), float(ce), **SCALAR_TOL)
    np.testing.assert_allclose(float(m["aux_loss"]), float(aux),
                               **SCALAR_TOL)
    scale = 0.1 * min(1.0, 1.0 / max(float(m["grad_norm"]), 1e-9))
    for name, w in want.items():
        _grad_close(cfg, state.mu[name] / scale, w, f"step's {name}")
    bound = 2 * float(TOPT.cosine_schedule(LR, WARMUP, 10_000)(1)) + 1e-6
    updated = CV.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, new_params), "cpu")
    for (name, got_p), (_, want_p) in zip(model.named_parameters(),
                                          updated.named_parameters()):
        err = float((got_p - want_p).abs().max())
        assert err <= bound, (name, err, bound)
    assert float((model.embed - torch.tensor(tree["embed"])).abs().max()) > 0


# -- the reference suite's training tests, on the port ------------------------

def _smoke_model(arch, seed=0, **over):
    cfg = dataclasses.replace(get_config(arch).smoke(), **over)
    return cfg, TLM.init_params(cfg, seed, device="cpu")


def test_grad_accumulation_matches_full_batch():
    """`tests/test_perf_opts.py::test_grad_accumulation_matches_full_batch`
    on the port: four microbatches give the full batch's loss and
    update."""
    cfg, model = _smoke_model("deepseek-7b")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)}
    other = copy.deepcopy(model)
    m1, _, s1 = make_train_step(cfg, accum_steps=1)(
        model, adamw_init(model), batch)
    m4, _, s4 = make_train_step(cfg, accum_steps=4)(
        other, adamw_init(other), batch)
    assert abs(float(s1["loss"]) - float(s4["loss"])) < 1e-4
    for (n, a), (_, b) in zip(m1.named_parameters(), m4.named_parameters()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=n)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, accum_steps=3)(m4, adamw_init(m4), batch)


def test_grouped_moe_train_step_finite():
    cfg, model = _smoke_model("granite-moe-1b-a400m", moe_dp_groups=2)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)}
    _, _, m = make_train_step(cfg)(model, adamw_init(model), batch)
    assert np.isfinite(float(m["loss"])) and float(m["aux_loss"]) > 0


def test_train_loss_decreases():
    """Loss drops on a repeated batch (`tests/test_models.py`), and the
    serving entry points still run without autograd after training."""
    cfg, model = _smoke_model("deepseek-7b")
    step = make_train_step(cfg, base_lr=3e-3, warmup=2)
    opt = adamw_init(model)
    batch = _batch(cfg, b=4, s=32)
    losses = []
    for _ in range(8):
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses
    model.requires_grad_(True)
    logits, caches = TLM.prefill_step(cfg, model, batch)
    full = TLM.logits_full(cfg, model, batch)
    tok = torch.from_numpy(batch["tokens"][:, -1])
    lg, _ = TLM.decode_step(cfg, model, tok, grow_dense(cfg, caches, 40))
    assert not any(t.requires_grad for t in (logits, full, lg,
                                             caches["k"]))
    hidden, _ = TLM.forward(cfg, model, batch)
    assert hidden.requires_grad          # forward itself trains


EXAMPLES = {
    "long_context_serve_torch.py": ([], "tiered cache:"),
    "train_lm_torch.py": (["--steps", "4", "--ckpt-every", "2",
                           "--d-model", "64", "--layers", "2", "--seq", "16",
                           "--batch", "4"],
                          "exact bitwise restore expected: OK")}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_mirror_runs_on_the_cpu(name, tmp_path):
    """The LM example mirrors with `--device cpu` exit 0 past their own
    checks (train_lm_torch: a few steps, its checkpoint restore drill
    bitwise). quickstart_torch.py drives the engine, whose parity the
    engine's test files hold; `chip_smoke.py` runs all three on the
    card."""
    extra, expect = EXAMPLES[name]
    if name == "train_lm_torch.py":
        extra = extra + ["--ckpt-dir", str(tmp_path)]
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
         *extra], capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert expect in out.stdout
