"""The port's `launch/` (`cost`, `dryrun`, `roofline`, `report`) against
the reference's `repro.launch` on the CPU: model FLOPs, decode kinds and
skips for every arch and shape; the per-device dot FLOPs of a step
against the reference's HLO walk (`hlo_cost.analyze` with its
elementwise set emptied, on the same step compiled for the CPU); hand
counts of a matmul, a pointwise op and, in a fake (2, 4) world run in a
child process, a column- then row-parallel matmul and a sharded train
step; the roofline and report text; the shape-only path of the
`lsm_attention` entry points; each kernel's `kernel_cost` at its main
path's shapes against the bound column of the kernel table."""
import json
import math
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import ARCHS as PORT_ARCHS  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.kernels.lsm_attention import ops as KLA  # noqa: E402
from repro_torch.launch import cost  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import report as PREP  # noqa: E402
from repro_torch.launch import roofline as PROOF  # noqa: E402
from repro_torch.models import lm as PLM  # noqa: E402
from repro_torch.train import adamw_init as p_adamw_init  # noqa: E402
from repro_torch.train import make_train_step as p_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCH_IDS = [a.replace("_", "-") for a in PORT_ARCHS]


@pytest.fixture(scope="module")
def ref():
    """The reference's launch modules; its `dryrun` sets XLA_FLAGS for
    512 host devices when imported, which is put back at once (no jax
    backend starts before then)."""
    pytest.importorskip("jax")
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun, hlo_cost, report, roofline
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun, hlo_cost, roofline, report


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_decode_kind_and_skips_match_reference(ref, arch):
    import jax

    from repro.configs import get_config as ref_config
    from repro.models import lm as RLM
    rd = ref[0]
    rcfg, pcfg = ref_config(arch), port_config(arch)
    rparams = jax.eval_shape(lambda: RLM.init_params(rcfg,
                                                     jax.random.PRNGKey(0)))
    pparams = PLM.LM(pcfg, torch.device("meta"))
    for shape, spec in DR.SHAPES.items():
        assert spec == rd.SHAPES[shape]
        args = (spec["kind"], spec["batch"], spec["seq"])
        assert DR.model_flops(pcfg, *args, pparams) \
            == rd.model_flops(rcfg, *args, rparams), shape
        assert DR.decode_kind(pcfg, shape) == rd.decode_kind(rcfg, shape)
        assert DR.cell_skip_reason(pcfg, shape) \
            == rd.cell_skip_reason(rcfg, shape)


def _port_step(cfg, kind: str, b: int, s: int):
    """The port's step of `kind` at smoke size on fake CPU tensors, no
    mesh, counted -> the counter."""
    with FakeTensorMode():
        model = PLM.init_params(cfg, 0, "cpu")
        if kind == "prefill":
            batch = DR.make_batch_specs(cfg, b, s, "cpu")
            batch.pop("labels")
            fn = partial(PLM.prefill_step, cfg, model, batch)
        elif kind == "decode":
            caches = PLM.init_decode_caches(cfg, b, s, "dense", "cpu")
            tok = torch.zeros(b, dtype=torch.int32)
            fn = partial(PLM.decode_step, cfg, model, tok, caches, "dense")
        else:
            opt = p_adamw_init(model)
            batch = DR.make_batch_specs(cfg, b, s, "cpu")
            fn = partial(p_train_step(cfg), model, opt, batch)
        with cost.CostCounter(fake_only=True) as c:
            fn()
    return c


def _ref_step_hlo(cfg, kind: str, b: int, s: int) -> str:
    import jax
    import jax.numpy as jnp

    from repro.models import lm as RLM
    from repro.train import adamw_init, make_train_step
    params = jax.eval_shape(lambda: RLM.init_params(cfg,
                                                    jax.random.PRNGKey(0)))
    toks = jax.ShapeDtypeStruct((b, s), jnp.int32)
    if kind == "prefill":
        fn, args = partial(RLM.prefill_step, cfg), (params, {"tokens": toks})
    elif kind == "decode":
        caches = jax.eval_shape(lambda: RLM.init_decode_caches(
            cfg, b, s, kind="dense"))
        fn = partial(RLM.decode_step, cfg, kind="dense")
        args = (params, jax.ShapeDtypeStruct((b,), jnp.int32), caches)
    else:
        fn = make_train_step(cfg)
        args = (params, jax.eval_shape(adamw_init, params),
                {"tokens": toks, "labels": toks})
    return jax.jit(fn).lower(*args).compile().as_text()


@pytest.mark.parametrize("arch,kind", [
    ("deepseek-7b", "prefill"), ("deepseek-7b", "decode"),
    ("deepseek-7b", "train"), ("qwen3-moe-30b-a3b", "prefill"),
    ("qwen3-moe-30b-a3b", "decode")])
def test_dot_flops_match_reference_hlo_walk(ref, monkeypatch, arch, kind):
    """Dot FLOPs of one step at `.smoke()` (batch 2 x 64), the port's
    dispatch count against the reference's HLO walk of the step compiled
    for the CPU, trip counts included, within 1%. One gap is named: the
    port's chunked cross-entropy is a checkpoint a chunk, so a train
    step computes each chunk's logits once more in its backward, 2 B S d
    Vp FLOPs that XLA's step computes once."""
    from repro.configs import get_config as ref_config
    hlo_cost = ref[1]
    monkeypatch.setattr(hlo_cost, "_ELEMWISE", set())
    b, s = 2, 64
    pcfg = port_config(arch).smoke()
    got = _port_step(pcfg, kind, b, s).dot_flops
    if kind == "train":
        got -= 2 * b * s * pcfg.d_model * pcfg.padded_vocab
    want = hlo_cost.analyze(_ref_step_hlo(ref_config(arch).smoke(), kind,
                                          b, s))["flops"]
    assert want > 0
    assert abs(got - want) <= 0.01 * want, (got, want)


def test_counts_hand_sized_matmul_and_pointwise():
    a, b = torch.ones(8, 16), torch.ones(16, 32)
    with cost.CostCounter() as c:
        y = a @ b
    assert c.dot_flops == c.flops == 2 * 8 * 16 * 32
    assert c.bytes == (8 * 16 + 16 * 32 + 8 * 32) * 4
    with cost.CostCounter() as c:
        z = y + y.t().t()          # two views, one add
    assert c.dot_flops == 0 and c.flops == 8 * 32
    assert c.bytes == 3 * 8 * 32 * 4
    with cost.CostCounter(track_memory=True) as c:
        c.mark_arguments(z)
        w = torch.exp(z) * 2.0
        del w
    assert c.argument_bytes == 8 * 32 * 4
    assert c.peak == 2 * 8 * 32 * 4     # exp's result beside the product
    assert c.flops == 2 * 8 * 32


_WORLD_CHILD = r"""
import json, math, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import cost, dryrun as DR
from repro_torch.launch.mesh import make_host_mesh

mesh = make_host_mesh(2, 4, device="cpu", fake=True)
out = {}
n, d, f = 8, 64, 256
with FakeTensorMode():
    x = distribute_tensor(torch.zeros(n, d), mesh, [Replicate()] * 2)
    w1 = distribute_tensor(torch.zeros(d, f), mesh, [Replicate(), Shard(1)])
    w2 = distribute_tensor(torch.zeros(f, d), mesh, [Replicate(), Shard(0)])
    with cost.CostCounter(fake_only=True) as c:
        y = ((x @ w1) @ w2).redistribute(mesh, [Replicate()] * 2)
    out["mlp"] = dict(flops=c.flops, coll=c.coll, counts=c.coll_counts,
                      local=list(y.to_local().shape))

cfg = get_config("deepseek-7b").smoke()
spec = dict(kind="train", seq=32, batch=8)
res = DR.count_cell(cfg, spec, mesh)

def local_bytes(shape, dtype, p):
    n = 1
    for size, e in zip(shape, p):
        axes = e if isinstance(e, tuple) else (e,) if e else ()
        n *= size // math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                               for a in axes)
    return n * dtype.itemsize

with FakeTensorMode():
    model = DR.lm.init_params(cfg, 0, "cpu")
    opt = DR.adamw_init(model)
    batch = DR.make_batch_specs(cfg, 8, 32, "cpu")
pspecs = SH.param_pspecs(cfg, model, mesh)
zspecs = SH.zero1_pspecs(cfg, opt, mesh)
bspecs = SH.batch_pspecs(cfg, batch, mesh)
want = (sum(local_bytes(p.shape, p.dtype, pspecs[k])
            for k, p in model.named_parameters())
        + sum(local_bytes(t.shape, t.dtype, zs[k])
              for tree, zs in ((opt.mu, zspecs.mu), (opt.nu, zspecs.nu))
              for k, t in tree.items())
        + 4 + sum(local_bytes(t.shape, t.dtype, bspecs[k])
                  for k, t in batch.items()))
out["train"] = dict(args=res["memory"]["argument_size_in_bytes"],
                    want=want, coll=res["collectives"],
                    dot_flops=res["dot_flops"], peak=res["memory"])

# a decode slot write on a cache whose positions are sharded over model
# (4 ranks x 4 of 16): real values, no collective needed
from torch.distributed.tensor import DTensor
from repro_torch.models.attention import _write_slot
cache = DTensor.from_local(torch.zeros(2, 4, 2, 8), mesh,
                           [Replicate(), Shard(1)], run_check=False)
_write_slot(cache, 3, torch.ones(2, 2, 8))    # in this rank's shard
_write_slot(cache, 9, torch.ones(2, 2, 8))    # in another rank's
out["write"] = [cache.to_local()[:, 3].sum().item(),
                cache.to_local().sum().item()]
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_world():
    """One child process with a fake (2, 4) world (the fake process group
    is global state: no test worker may see it)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _WORLD_CHILD], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    assert proc.returncode == 0 and line, proc.stdout + proc.stderr[-4000:]
    return json.loads(line[0][len("RESULT "):])


def test_fake_world_column_row_parallel_matmul(fake_world):
    """x (8, 64) replicated @ w1 (64, 256) columns over model (4) @ w2
    rows over model: each rank multiplies its 64 columns and rows, and
    the partial (8, 64) f32 sums are all-reduced over model."""
    got = fake_world["mlp"]
    n, d, f, tp = 8, 64, 256, 4
    assert got["flops"] == 2 * n * d * (f // tp) + 2 * n * (f // tp) * d
    assert got["coll"]["all-reduce"] == n * d * 4
    assert got["counts"]["all-reduce"] == 1
    assert sum(got["coll"].values()) == n * d * 4
    assert got["local"] == [n, d]


def test_fake_world_sharded_train_step(fake_world):
    """deepseek-7b smoke's train step on the (2, 4) fake world: its
    argument bytes are the local shards of weights (param_pspecs), ZeRO-1
    moments (zero1_pspecs), step and batch (batch_pspecs), by hand from
    the global shapes; it all-reduces gradients."""
    got = fake_world["train"]
    assert got["args"] == got["want"]
    assert got["coll"]["all-reduce"] > 0
    assert got["dot_flops"] > 0
    assert got["peak"]["temp_size_in_bytes"] > 0


def test_fake_world_decode_slot_write_lands_in_its_shard(fake_world):
    """A decode step's K/V write into a cache sharded on its positions
    lands in place in the rank that holds the position (DTensor's own
    `cache[:, at] = row` gathers the positions and writes a copy), and
    nowhere else."""
    assert fake_world["write"] == [2 * 2 * 8, 2 * 2 * 8]


def _records(d: Path):
    """A few records of the dry run's form: ok cells on both meshes, a
    tiered decode, a skip and an error."""
    d.mkdir(parents=True)
    recs = []
    for i, (arch, shape) in enumerate([
            ("phi4-mini-3-8b", "train_4k"), ("phi4-mini-3-8b", "long_500k"),
            ("gemma-7b", "decode_32k"), ("qwen3-moe-30b-a3b", "prefill_32k"),
            ("whisper-tiny", "long_500k"), ("mamba2-370m", "train_4k")]):
        for mesh, chips in (("pod16x16", 256), ("pod2x16x16", 512)):
            r = {"arch": arch, "shape": shape, "mesh": mesh, "chips": chips}
            if arch == "whisper-tiny":
                r["skipped"] = "whisper decoder is bounded at 448 positions"
            elif arch == "mamba2-370m" and mesh == "pod2x16x16":
                r["error"] = "RuntimeError: x"
            else:
                t = [1.5e-3 * (i + 1), 2.5e-2 / (i + 1), 7.0e-4 * i * i]
                r.update(t_compute=t[0], t_memory=t[1], t_collective=t[2],
                         bottleneck=("compute", "memory", "collective")[
                             t.index(max(t))],
                         useful_flops_ratio=0.3 + 0.05 * i,
                         roofline_fraction=t[0] / max(t),
                         decode_kind=("lsm" if shape == "long_500k" else
                                      "dense" if "decode" in shape else None),
                         compile_s=3.0 * i + chips / 256,
                         memory={"argument_size_in_bytes": 1e9 * (i + 1),
                                 "output_size_in_bytes": 1e6,
                                 "temp_size_in_bytes": 2.5e9 * (7 - i)})
            recs.append(r)
            name = f"{arch}__{shape}__{mesh}.json"
            (d / name).write_text(json.dumps(r))
    return recs


def test_roofline_and_report_text_match_reference(ref, monkeypatch,
                                                  tmp_path):
    _, _, rroof, rrep = ref
    _records(tmp_path / "dryrun")
    _records(tmp_path / "base")
    for mod in (rroof, PROOF):
        monkeypatch.setattr(mod, "RESULTS_DIR", str(tmp_path / "dryrun"))
    for mod in (rrep, PREP):
        monkeypatch.setattr(mod, "BASE", str(tmp_path))
    for mesh in ("pod16x16", "pod2x16x16"):
        assert PROOF.table(mesh) == rroof.table(mesh)
        assert PROOF.pick_hillclimb(mesh) == rroof.pick_hillclimb(mesh)
        recs_p, recs_r = PREP.load("dryrun"), rrep.load("dryrun")
        assert recs_p == recs_r
        assert PREP.roofline_table(recs_p, mesh) \
            == rrep.roofline_table(recs_r, mesh)
    cells = [("phi4-mini-3-8b", "train_4k"), ("gemma-7b", "decode_32k")]
    base, opt = PREP.load("base"), PREP.load("dryrun", "pod16x16")
    assert PREP.before_after(base, opt, cells) \
        == rrep.before_after(base, opt, cells)
    assert PREP.dryrun_summary(PREP.load("dryrun")) \
        == rrep.dryrun_summary(rrep.load("dryrun"))


def test_lsm_attention_fake_inputs_record_the_kernel_and_run_nothing():
    """FakeTensor inputs: each entry point returns the kernel's output
    shape and dtype and records `kernel_cost` (every row it may read),
    and no op of the plain version runs."""
    b, h, kv, dh, w, nb, mu, topk, length = 2, 8, 2, 64, 96, 4, 32, 2, 160
    bf = torch.bfloat16
    with FakeTensorMode():
        q = torch.empty(b, h, dh, dtype=bf)
        k = torch.empty(b, length, kv, dh, dtype=bf)
        hot = torch.empty(b, w, kv, dh, dtype=bf)
        blk = torch.empty(b, nb, mu, kv, dh, dtype=bf)
        hot_len = torch.zeros(b, dtype=torch.int32)
        ids = torch.zeros(b, kv, topk, dtype=torch.int64)
        ok = torch.ones(b, kv, topk, dtype=torch.bool)
        valid = torch.ones(b, kv, length, dtype=torch.int8)
        launches = KLA.decode_attention.launches
        with cost.CostCounter() as c:
            outs = [KLA.lsm_decode_attention(q, hot, hot, hot_len, blk, blk,
                                             ids, ok, 0.125),
                    KLA.decode_attention_op(q, k, k, hot_len, 0.125),
                    KLA.decode_attention(q, k, k, valid, 0.125)]
    assert KLA.decode_attention.launches == launches
    for o in outs:
        assert o.shape == (b, h, dh) and o.dtype == bf
    want = [cost.kernel_cost("lsm_attention", b=b, h=h, kv=kv, dh=dh,
                             rows=rows, elt=2, **mode)
            for rows, mode in (
                (b * kv * (w + topk * mu), dict(mode="tiered", topk=topk)),
                (b * kv * length, dict(mode="lengths")),
                (b * kv * length, dict(mode="bitmap", length=length)))]
    assert c.kernels["lsm_attention"] == {
        "calls": 3, "flops": sum(f for f, _ in want),
        "bytes": sum(n for _, n in want)}
    # no op of the plain version traced: only the three empty outputs
    assert c.dot_flops == c.flops == sum(f for f, _ in want)
    assert c.bytes == sum(n for _, n in want) and c.ops == 0


def test_fake_inputs_outside_a_counter_raise():
    """With no cost counter active, FakeTensor inputs never take the
    shape-only path: each entry point and the decode step's host read
    raise, so none can return an empty output as a result."""
    from repro_torch import shape_only
    b, h, kv, dh, w, nb, mu, topk = 1, 4, 2, 16, 8, 2, 4, 1
    with FakeTensorMode():
        q = torch.empty(b, h, dh)
        hot = torch.empty(b, w, kv, dh)
        blk = torch.empty(b, nb, mu, kv, dh)
        lens = torch.zeros(b, dtype=torch.int32)
        ids = torch.zeros(b, kv, topk, dtype=torch.int64)
        ok = torch.ones(b, kv, topk, dtype=torch.bool)
        valid = torch.ones(b, kv, w, dtype=torch.int8)
        calls = [
            lambda: KLA.lsm_decode_attention(q, hot, hot, lens, blk, blk,
                                             ids, ok, 0.25),
            lambda: KLA.decode_attention_op(q, hot, hot, lens, 0.25),
            lambda: KLA.decode_attention(q, hot, hot, valid, 0.25),
            lambda: shape_only.host_ints(lens)]
        for call in calls:
            with pytest.raises(RuntimeError, match="outside a cost counter"):
                call()
    assert shape_only.host_ints(torch.tensor([3, 5])) == [3, 5]


@pytest.mark.parametrize("name,shape,table_ms", [
    ("bloom_probe", dict(q=4096, rows=40, words=323944), 0.000441),
    ("fence_lookup", dict(q=4096, runs=20, fence_words=29188,
                          key_words=461283), 0.000688),
    ("heap_merge", dict(lanes=20 * 40448), 0.00773),
    ("range_merge", dict(rows=32, lanes=512, filled=10402, parts=91),
     0.000136),
    ("lsm_attention", dict(b=2, h=24, kv=8, dh=128, rows=271160, elt=2,
                           mode="tiered", topk=16), 0.0415)])
def test_kernel_cost_reproduces_the_kernel_table_bounds(name, shape,
                                                        table_ms):
    """Each kernel at its main path's shape (the distinct words, filled
    lanes and valid rows of the chip run the table's bound came from)
    gives the table's bound to its three significant figures."""
    ms, by = cost.bound_ms(*cost.kernel_cost(name, **shape))
    assert by == "bytes"
    assert float(f"{ms:.3g}") == table_ms
    assert math.isclose(cost.bound_ms(0, 3.35e9)[0], 1.0)
