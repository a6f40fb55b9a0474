"""Port parity of `distributed/` and `launch/mesh.py`, and the mesh branches
of `moe_ffn` and tiered attention, against the reference on the CPU.

In process: int8 compression bitwise on f32 leaves; the sharding rules
for every architecture on abstract (16, 16) and (2, 16, 16) meshes
against the reference's rules on `jax.sharding.AbstractMesh`;
`factor_devices`, `StragglerMonitor`, `bubble_fraction`.

Multi-rank: one gloo world of 8 CPU processes (`tests/torch_dist_worker.py`,
one intra-op thread each, a free localhost port, 300 s for the whole
world) runs every check once; each test below asserts on its result.
The reference's own multi-device tests are red on this jax, so the mesh
results are held against the reference's single-device results, at the
bounds of `tests/test_distributed.py`:
- (a) a sharded `make_train_step` step (deepseek-7b smoke, and
  qwen3-moe smoke through the moe mesh branch, (2, 4)): loss
  and aux 1e-5 relative to the port's one-process step and to the
  reference's (moe: with moe_dp_groups = |DP|, the rows each DP shard
  routes); first moments at the train tests' rule (rtol 1e-4, atol 1e-6
  x max(1, the leaf's largest)); updated parameters at that rule where
  the gradient is at least 1e-3 of its leaf's largest, and all within
  2 * lr + 1e-6; every DTensor placed as its spec says;
- (b) qwen3-moe smoke `logits_full` through the mesh branch, (2, 4):
  max abs < 2e-4, with no expert over its capacity in either dispatch;
- (c) GPipe over 8 stages against the sequential scan, < 1e-5;
- (d) one tiered decode step through the sharded-stats branch, (4, 2):
  < 2e-3 against the reference's and the port's single-device decode;
- (e) elastic reshard (2, 4) -> host -> 2 x 2, bitwise;
- (f) (d) with the stats merge's all-reduce(MAX) made local must miss
  (d)'s bound;
- (g) prefill and three teacher-forced decode steps on (4, 2), with the
  model, batch and caches as DTensors laid out by the sharding rules,
  against the same on one process, < 2e-3 (as (d)): dense at batch 2
  (the cache's positions over data), tiered at batch 2 (the kernel
  branch: q's heads over model, the blocks over data) and at batch 1
  (the stats branch on DTensor blocks);
- (h) qwen3-moe smoke's `moe_ffn` on (2, 4) at batch 1 (a batch DP does
  not divide) against one process, < 2e-3.
"""
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import all_arch_ids as ref_arch_ids  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.distributed import compress as RC  # noqa: E402
from repro.distributed import elastic as RE  # noqa: E402
from repro.distributed import pipeline as RPIPE  # noqa: E402
from repro.distributed import sharding as RSH  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.serving import lsm_from_dense as ref_lsm_from_dense  # noqa: E402
from repro.train import adamw_init as ref_adamw_init  # noqa: E402
from repro.train import optimizer as ROPT  # noqa: E402
from repro.train import train_step as RTS  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import all_arch_ids, get_config  # noqa: E402
from repro_torch.distributed import compress as TC  # noqa: E402
from repro_torch.distributed import elastic as TE  # noqa: E402
from repro_torch.distributed import pipeline as TPIPE  # noqa: E402
from repro_torch.distributed import sharding as TSH  # noqa: E402
from repro_torch.launch.mesh import MeshShape, axis_size, dp_axes  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.train import adamw_init, make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
import torch_dist_worker as W  # noqa: E402

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
WORLD, WORLD_TIMEOUT = 8, 300
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# XLA's CPU backend without its LLVM optimisations (as test_torch_train)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# compression
# --------------------------------------------------------------------------

def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(300,)).astype(np.float32),
            "m": (rng.normal(size=(37, 53)) * 1e-3).astype(np.float32),
            "b": rng.normal(size=(256,)).astype(np.float32) * 50,
            "z": np.zeros((5,), np.float32)}


def test_int8_roundtrip_bitwise_reference():
    for k, x in _leaves().items():
        q, s, n = TC.quantize_int8(torch.from_numpy(x))
        rq, rs, rn = RC.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq), err_msg=k)
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs), err_msg=k)
        assert n == rn
        np.testing.assert_array_equal(
            TC.compress_roundtrip(torch.from_numpy(x)).numpy(),
            np.asarray(RC.compress_roundtrip(jnp.asarray(x))), err_msg=k)


def test_int8_roundtrip_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5] + [0.0] * 250)
    np.testing.assert_array_equal(
        TC.compress_roundtrip(x).numpy(),
        np.asarray(RC.compress_roundtrip(jnp.asarray(x.numpy()))))
    assert TC.compress_roundtrip(x)[1:4].tolist() == [0.0, 2.0, 2.0]


def test_error_feedback_invariant_and_reference():
    """sum(applied) + residual_T == sum(grads) over 5 steps, and each
    step's applied grads and residual bitwise the reference's."""
    leaves = _leaves(1)
    res = TC.init_residual({k: torch.from_numpy(v) for k, v in leaves.items()})
    rres = RC.init_residual({k: jnp.asarray(v) for k, v in leaves.items()})
    tot_a = {k: torch.zeros(v.shape) for k, v in leaves.items()}
    tot_g = {k: torch.zeros(v.shape) for k, v in leaves.items()}
    for i in range(5):
        g = {k: torch.from_numpy(v) * (i + 1) * 0.1 for k, v in leaves.items()}
        applied, res = TC.ef_compress_grads(g, res)
        rapplied, rres = RC.ef_compress_grads(
            {k: jnp.asarray(v.numpy()) for k, v in g.items()}, rres)
        for k in leaves:
            np.testing.assert_array_equal(applied[k].numpy(),
                                          np.asarray(rapplied[k]))
            np.testing.assert_array_equal(res[k].numpy(), np.asarray(rres[k]))
            tot_a[k] += applied[k]
            tot_g[k] += g[k]
    for k in leaves:
        np.testing.assert_allclose((tot_a[k] + res[k]).numpy(),
                                   tot_g[k].numpy(), rtol=1e-5, atol=1e-5)


def test_compression_ratio_matches_reference():
    shapes = {"w": (4096, 512), "b": (300,), "e": (7, 33)}
    got = TC.compression_ratio({k: torch.zeros(s, dtype=torch.bfloat16)
                                for k, s in shapes.items()})
    want = RC.compression_ratio({k: jnp.zeros(s, jnp.bfloat16)
                                 for k, s in shapes.items()})
    assert got == want and got < 0.55
    assert TC.compression_ratio({"w": torch.zeros(4096, 512)},
                                torch.float32) == RC.compression_ratio(
        {"w": jnp.zeros((4096, 512))}, jnp.float32)


# --------------------------------------------------------------------------
# sharding rules, every architecture, abstract meshes
# --------------------------------------------------------------------------

def _ref_mesh(shape, names):
    return jax.sharding.AbstractMesh(shape, names)


def _key(k):
    return str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))


def _ref_flat(tree, specs):
    """{path tuple: (leaf shape, spec tuple)} of a reference tree."""
    sp = dict(jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP)))
    return {tuple(_key(k) for k in p): (tuple(leaf.shape), tuple(sp[p]))
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _to_port(spec, rank, stacked, transposed):
    """A reference spec as the port's leaf carries it: without the L entry
    of a stacked leaf, full rank, dims swapped for a transposed leaf."""
    spec = tuple(spec)
    if stacked:
        spec = spec[1:]
    spec = spec + (None,) * (rank - len(spec))
    return spec[::-1] if transposed else spec


def test_arch_registries_agree():
    assert sorted(all_arch_ids()) == sorted(ref_arch_ids())


@pytest.mark.parametrize("shape,names", MESHES)
def test_param_and_zero1_specs_match_reference(shape, names):
    """Parameters spec for spec through the name/transposition/stacking
    map. ZeRO-1: the port's spec is the reference's rule on the leaf the
    port holds (its per-layer, reference-oriented moment under `mu`);
    against the reference's stacked moments it is equal but where the
    reference chose L or based the moment on another layout than its
    parameter's (the stacking lost under the `mu` key), which are
    counted and must explain every difference."""
    rmesh, tmesh = _ref_mesh(shape, names), MeshShape(names, shape)
    dp = dp_axes(tmesh)
    dpn, tp = axis_size(tmesh, *dp), axis_size(tmesh, "model")
    explained = exact = 0
    for arch in all_arch_ids():
        rcfg, cfg = ref_config(arch), get_config(arch)
        params = jax.eval_shape(lambda: RLM.init_params(
            rcfg, jax.random.PRNGKey(0)))
        ref_p = _ref_flat(params, RSH.param_pspecs(rcfg, params, rmesh))
        opt = jax.eval_shape(ref_adamw_init, params)
        ref_z = _ref_flat(opt, RSH.zero1_pspecs(rcfg, opt, rmesh))
        model = TLM.LM(cfg, torch.device("meta"))
        got_p = TSH.param_pspecs(cfg, model, tmesh)
        got_z = TSH.zero1_pspecs(cfg, adamw_init(model), tmesh)
        assert got_z.step == () and got_z.mu == got_z.nu
        one = {}
        for name, t in model.named_parameters():
            path, layer, tr = CV._lm_source(name)
            stacked = layer is not None
            rshape, rspec = ref_p[path]
            want = _to_port(rspec, t.ndim, stacked, tr)
            assert tuple(got_p[name]) == want, (arch, name)
            # the reference's rule on the port's own (unstacked) leaf
            ushape = rshape[1:] if stacked else rshape
            one[name] = {path[-1]: jax.ShapeDtypeStruct(ushape, jnp.float32)}
            _, zspec = ref_z[("mu",) + path]
            zwant = _to_port(zspec, t.ndim, stacked, tr)
            base = tuple(RSH._param_spec(["mu", *path], rshape, tp))
            chose_l = stacked and zspec and zspec[0] is not None
            if tuple(got_z.mu[name]) == zwant:
                exact += 1
            else:
                assert chose_l or base != tuple(rspec), (arch, name)
                explained += 1
                # where they differ the port shards the first free axis
                # (reference orientation) that divides |DP|, or none
                free = [i for i, e in enumerate(want[::-1] if tr else want)
                        if e is None and ushape[i] % dpn == 0]
                z = got_z.mu[name]
                zr = tuple(z)[::-1] if tr else tuple(z)
                dp_s = dp if len(dp) > 1 else dp[0]
                assert [i for i, e in enumerate(zr) if e == dp_s] == free[:1]
        unstacked = RSH.zero1_pspecs(rcfg, {"mu": one}, rmesh)["mu"]
        for name, t in model.named_parameters():
            path, _, tr = CV._lm_source(name)
            spec = tuple(unstacked[name][path[-1]])
            spec = spec + (None,) * (t.ndim - len(spec))
            assert tuple(got_z.mu[name]) == (spec[::-1] if tr else spec), (
                arch, name)
    assert exact > 0 and explained > 0, (exact, explained)


def _batches(cfg):
    out = []
    for b, s in ((256, 64), (1, 4096), (3, 7)):
        rng = {"tokens": (b, s), "labels": (b, s)}
        if cfg.family == "vlm":
            rng["positions3"] = (3, b, s)
        if cfg.family == "encdec":
            rng["frames"] = (b, 1500, cfg.d_model)
        out.append(rng)
    return out


@pytest.mark.parametrize("shape,names", MESHES)
def test_batch_and_cache_specs_match_reference(shape, names):
    """Batches and decode caches (lsm, dense, ssm, encdec, hybrid) keep the
    reference's layout and names, so their specs match directly."""
    rmesh, tmesh = _ref_mesh(shape, names), MeshShape(names, shape)
    for arch in all_arch_ids():
        rcfg, cfg = ref_config(arch), get_config(arch)
        for batch in _batches(cfg):
            rb = {k: jax.ShapeDtypeStruct(v, jnp.int32)
                  for k, v in batch.items()}
            want = RSH.batch_pspecs(rcfg, rb, rmesh)
            got = TSH.batch_pspecs(cfg, batch, tmesh)
            assert {k: tuple(v) for k, v in want.items()} == got, arch
        for kind in ("dense", "lsm"):
            for b, max_len in ((1, 32768), (32, 4096)):
                rc = jax.eval_shape(lambda: RLM.init_decode_caches(
                    rcfg, b, max_len, kind))
                want = _ref_flat(rc, RSH.cache_pspecs(rcfg, rc, rmesh))
                tc = TLM.init_decode_caches(cfg, b, max_len, kind,
                                            device="meta")
                got = TSH.cache_pspecs(cfg, tc, tmesh)

                def flat(t, pre=()):
                    out = {}
                    for k, v in t.items():
                        out.update(flat(v, pre + (k,)) if isinstance(v, dict)
                                   else {pre + (k,): v})
                    return out
                fg, ft = flat(got), flat(tc)
                assert set(fg) == set(want), (arch, kind)
                for k, (sh, spec) in want.items():
                    assert tuple(ft[k].shape) == sh, (arch, kind, k)
                    assert tuple(fg[k]) == spec, (arch, kind, k)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    class M:
        mesh_dim_names = ("pod", "data", "model")
    assert TSH.placements(M, TSH.P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert TSH.placements(M, TSH.P()) == (Replicate(),) * 3
    model = TLM.LM(get_config("deepseek-7b").smoke(), torch.device("meta"))
    specs = TSH.zero1_pspecs(None, adamw_init(model),
                             MeshShape(M.mesh_dim_names, (2, 2, 4)))
    tree = TSH.named(M, specs)
    assert tree.step == (Replicate(),) * 3
    assert tree.mu["embed"] == TSH.placements(M, specs.mu["embed"])


def test_meshes_on_a_world_of_one():
    """make_host_mesh needs the world to equal its product and
    make_production_mesh 256 or 512 ranks; dp_axes and axis_size read a
    DeviceMesh as they read a MeshShape."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (init_process_group,
                                         make_host_mesh,
                                         make_production_mesh)
    init_process_group("cpu", rank=0, world_size=1,
                       init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        mesh = make_host_mesh(1, 1, device="cpu")
        assert dp_axes(mesh) == ("data",)
        assert axis_size(mesh, "data", "model", "pod") == 1
        pod = make_host_mesh(1, 1, pod=1, device="cpu")
        assert dp_axes(pod) == ("pod", "data")
        for multi_pod in (False, True):
            with pytest.raises(ValueError, match="ranks"):
                make_production_mesh(multi_pod=multi_pod, device="cpu")
        with pytest.raises(ValueError, match="ranks"):
            make_host_mesh(2, 1, device="cpu")
    finally:
        dist.destroy_process_group()
    shape = MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert dp_axes(shape) == ("pod", "data")
    assert axis_size(shape, "pod", "data") == 32


# --------------------------------------------------------------------------
# elastic, stragglers, pipeline bookkeeping
# --------------------------------------------------------------------------

def test_factor_devices_matches_reference():
    for n in (1, 6, 7, 8, 48, 96, 256, 384, 512, 1000):
        for pm in (1, 2, 4, 16, 32):
            assert TE.factor_devices(n, pm) == RE.factor_devices(n, pm)
    assert TE.factor_devices(6, 4) == (2, 3)


def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(3)
    kw = dict(threshold=2.0, min_samples=4, window=8, quarantine_after=3)
    t, r = TE.StragglerMonitor(**kw), RE.StragglerMonitor(**kw)
    for _ in range(200):
        host = int(rng.integers(0, 5))
        dt = float(rng.choice([1.0, 1.1, 0.9, 5.0, 2.5]))
        assert t.record(host, dt) == r.record(host, dt)
    assert t.healthy_hosts(list(range(5))) == r.healthy_hosts(list(range(5)))


def test_bubble_fraction_and_stage_split_match_reference():
    for m, p in ((4, 8), (1, 1), (16, 4), (7, 3)):
        assert TPIPE.bubble_fraction(m, p) == RPIPE.bubble_fraction(m, p)
    w = np.arange(16 * 6, dtype=np.float32).reshape(16, 2, 3)
    got = TPIPE.split_layers_into_stages({"w": torch.from_numpy(w)}, 8)
    want = RPIPE.split_layers_into_stages({"w": jnp.asarray(w)}, 8)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))


# --------------------------------------------------------------------------
# the gloo world of 8
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run every multi-rank check once; -> {check: rank 0's result} (the
    elastic check: {rank: result} for ranks 0-3)."""
    out = tmp_path_factory.mktemp("gloo_world")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
         str(r), str(WORLD), str(port), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORLD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = {"_rcs": [p.returncode for p in procs], "_log": logs[0][-4000:]}
    for name, _ in W.CHECKS:
        errs = sorted(out.glob(f"{name}.err.*"))
        if errs:
            res[name] = errs[0].read_text()
        elif name == "elastic":
            res[name] = {r: dict(np.load(out / f"elastic.{r}.npz"))
                         for r in range(4)}
        else:
            f = out / f"{name}.0.npz"
            res[name] = dict(np.load(f)) if f.exists() else "no result"
    return res


def _result(world, name):
    r = world[name]
    assert world["_rcs"] == [0] * WORLD, world["_log"]
    assert not isinstance(r, str), r
    return r


def _ref_tree(model):
    return jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                        CV.lm_params_to_numpy(model))


def test_world_ranks_all_exit_cleanly(world):
    assert world["_rcs"] == [0] * WORLD, world["_log"]


@pytest.mark.parametrize("arch", W.TRAIN_ARCHS)
def test_sharded_train_step_matches_single_device(world, arch):
    """(a) loss, first moments, updated parameters and placements; the
    moe model (its mesh branch's gradients: each rank's part of the
    router, the experts and the rows) with no expert over its capacity
    in either dispatch."""
    r = _result(world, f"train_{arch}")
    assert bool(r["placed"])
    cfg, rcfg = get_config(arch).smoke(), ref_config(arch).smoke()
    batch = W.train_batch(cfg)
    model = TLM.init_params(cfg, 0, device="cpu")
    if cfg.family == "moe":
        # the mesh routes each DP shard's rows on their own (capacity and
        # aux from its tokens): on one device, moe_dp_groups = |DP| groups
        # of the same rows
        cfg, rcfg = (dataclasses.replace(c, moe_dp_groups=2)
                     for c in (cfg, rcfg))
        assert float(r["load"]) <= 1.0
        assert _moe_loads(cfg, model, {"tokens": batch["tokens"]}) <= 1.0
    tree = _ref_tree(model)
    opt = adamw_init(model)
    step = make_train_step(cfg, base_lr=W.LR, warmup=W.WARMUP)
    model, opt, m = step(model, opt, batch)
    rstep = RTS.make_train_step(rcfg, base_lr=W.LR, warmup=W.WARMUP)
    run = jax.jit(lambda p: rstep(p, ROPT.adamw_init(p), {
        k: jnp.asarray(v) for k, v in batch.items()}))
    _, rstate, rm = run.lower(tree).compile(FAST_COMPILE)(tree)
    for k in ("loss", "aux_loss"):
        for want in (float(m[k]), float(rm[k])):
            np.testing.assert_allclose(float(r[k]), want, rtol=1e-5,
                                       err_msg=k)
    np.testing.assert_allclose(float(r["grad_norm"]), float(m["grad_norm"]),
                               rtol=1e-5)
    ref_mu = dict(CV.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, rstate.mu), "cpu").named_parameters())
    for name, p in model.named_parameters():
        mu = opt.mu[name].numpy()
        for got, want in ((r["mu:" + name], mu),
                          (r["mu:" + name], ref_mu[name].numpy())):
            _grad_rule(got, want, name)
        # Adam's first step moves an entry by about lr x the sign of its
        # gradient, so an entry whose gradient is near zero (below 1e-3 of
        # the leaf's largest) may move either way: those are held to
        # 2 * lr + 1e-6 (the train tests' bound), all others to the rule
        got, want = r["p:" + name], p.detach().numpy()
        sure = np.abs(mu) >= 1e-3 * np.abs(mu).max()
        _grad_rule(got[sure], want[sure], name)
        assert np.abs(got - want).max() <= 2 * W.LR + 1e-6, name


def _grad_rule(got, want, what):
    """rtol 1e-4, atol 1e-6 x max(1, the leaf's largest |want|)."""
    atol = GRAD_ATOL * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol,
                               err_msg=what)


def _moe_loads(cfg, model, batch):
    """The single-device dispatch's largest expert load over its
    capacity (its token groups: moe_dp_groups of them)."""
    with W._loads(cfg) as loads:
        TLM.logits_full(cfg, model, batch)
    return max(loads.loads)


def test_moe_mesh_branch_matches_reference(world):
    """(b) through the mesh branch in every layer; no expert over its
    capacity in the mesh or the single-device dispatch, so both compute
    the same function."""
    r = _result(world, "moe")
    cfg = get_config("qwen3-moe-30b-a3b").smoke()
    rcfg = ref_config("qwen3-moe-30b-a3b").smoke()
    assert int(r["mesh_calls"]) == cfg.n_layers
    batch = W.moe_batch(cfg)
    model = TLM.init_params(cfg, 0, device="cpu")
    assert float(r["load"]) <= 1.0
    assert _moe_loads(cfg, model, batch) <= 1.0
    want, _ = RLM.logits_full(rcfg, _ref_tree(model),
                              {"tokens": jnp.asarray(batch["tokens"])})
    err = float(np.abs(r["logits"] - np.asarray(want)).max())
    assert err < 2e-4, err


def test_gpipe_matches_sequential(world):
    """(c) every rank returns the same outputs, equal to the scan."""
    r = _result(world, "pipe")
    assert bool(r["same"])
    w, x = W.pipe_inputs()
    want = torch.from_numpy(x)
    for wl in torch.from_numpy(w):
        want = torch.tanh(want @ wl)
    err = float(np.abs(r["out"] - want.numpy()).max())
    assert err < 1e-5, err


def _ref_lsm_logits():
    cfg = W.lsm_cfg()
    rcfg = ref_config("deepseek-7b").smoke()
    rcfg = type(rcfg)(**{**rcfg.__dict__, "n_kv": 2, "n_heads": 4})
    tree = _ref_tree(TLM.init_params(cfg, 0, device="cpu"))
    toks = jnp.asarray(W.lsm_tokens(cfg))
    s = toks.shape[1] - 1
    _, dense = RLM.prefill_step(rcfg, tree, {"tokens": toks[:, :s]})
    lsm = ref_lsm_from_dense(rcfg, dense, s + 16)
    logits, _ = RLM.decode_step(rcfg, tree, toks[:, s], lsm, kind="lsm")
    return np.asarray(logits)


@pytest.fixture(scope="module")
def ref_lsm():
    return _ref_lsm_logits()


def test_lsm_stats_branch_matches_reference(world, ref_lsm):
    """(d) the stats branch in every layer, the single-device branch in
    none; both within 2e-3 of the reference's decode."""
    r = _result(world, "lsm")
    cfg = W.lsm_cfg()
    assert int(r["stats_calls"]) == cfg.n_layers
    assert int(r["single_stats_calls"]) == 0
    for got in (r["logits"], r["single"]):
        err = float(np.abs(got - ref_lsm).max())
        assert err < 2e-3, err
    assert float(np.abs(r["logits"] - r["single"]).max()) < 2e-3


def test_elastic_reshard_roundtrip(world):
    """(e) (2, 4) -> host -> the 2 x 2 mesh of ranks 0-3, bitwise."""
    r = _result(world, "elastic")
    want = np.arange(64, dtype=np.float32).reshape(8, 8)
    for rank in range(4):
        np.testing.assert_array_equal(r[rank]["w"], want)
        assert tuple(r[rank]["mesh1"]) == (2, 4)
        assert tuple(r[rank]["mesh2"]) == (2, 2)
        assert tuple(r[rank]["local1"]) == (4, 2)
        assert tuple(r[rank]["local2"]) == (4, 4)


def test_planted_stats_merge_fault_is_caught(world, ref_lsm):
    """(f) the merge with each rank's local max in place of the
    all-reduce(MAX) must fail (d)'s bound."""
    r = _result(world, "lsm_fault")
    assert int(r["stats_calls"]) == W.lsm_cfg().n_layers
    err = float(np.abs(r["logits"] - ref_lsm).max())
    assert err >= 2e-3, err


# the placements each case's caches must have on (4, 2): dense k/v
# (L, B, S, KV, hd) positions over data, kv heads over model; tiered
# blk (L, B, NB, mu, KV, hd) blocks over data, kv heads over model
_POS_DATA, _BLK_DATA = "(Shard(dim=2), Shard(dim=3))", \
    "(Shard(dim=2), Shard(dim=4))"
_HEADS_Q = "(Replicate(), Shard(dim=1))"


@pytest.mark.parametrize("case", list(W.SERVE_CASES))
def test_serving_on_the_mesh_matches_single_device(world, case):
    """(g) the prefill's logits and K/V (its caches made by the mesh's
    own `_mesh_caches`), then each decode step's logits, mesh against one
    process; the layouts and the branch each case is there to reach."""
    r = _result(world, f"serve_{case}")
    b, kind = W.SERVE_CASES[case]
    assert str(r["prefill_place"]) == _POS_DATA
    keys = ["prefill", "prefill_k",
            *(f"step{i}" for i in range(W.SERVE_STEPS))]
    for k in keys:
        assert r[k].shape == r["single:" + k].shape, k
        err = float(np.abs(r[k] - r["single:" + k]).max())
        assert err < 2e-3, (k, err)
    place = dict(zip(sorted(["k", "v", "pos"] if kind == "dense" else
                            ["blk_k", "blk_v", "hot_k", "hot_len", "hot_v",
                             "n_blocks", "pos", "summ"]),
                     r["cache_place"]))
    if kind == "dense":
        assert place["k"] == place["v"] == _POS_DATA
    else:
        assert place["blk_k"] == place["blk_v"] == _BLK_DATA
    # each step reaches the kernel entry points per rank with q's heads
    # over model; batch 1 takes the stats branch in every layer and step,
    # batch 2 the kernel branch
    assert list(r["q_place"]) == [_HEADS_Q]
    want_stats = W.lsm_cfg().n_layers * W.SERVE_STEPS \
        if (kind, b) == ("lsm", 1) else 0
    assert int(r["stats_calls"]) == want_stats
    assert int(r["single:stats_calls"]) == 0


def test_moe_batch_one_on_the_mesh_matches_single_device(world):
    """(h) through the mesh branch, x whole on every DP rank."""
    r = _result(world, "moe_b1")
    assert int(r["mesh_calls"]) == 1
    assert r["y"].shape == r["single_y"].shape
    assert float(np.abs(r["y"] - r["single_y"]).max()) < 2e-3
    assert abs(float(r["aux"]) - float(r["single_aux"])) < 2e-3
