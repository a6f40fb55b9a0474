"""One rank of the gloo world that `tests/test_torch_distributed.py` starts:
every multi-rank check of the port's `distributed/` in sequence, each
result written to `<out>/<check>.<rank>.npz` by rank 0 (ranks 0-3 for
the elastic check's second mesh), or `<out>/<check>.err.<rank>` with the
traceback. Imports the port and torch only; the test compares the
results with the reference and with the port on one process.

    python tests/torch_dist_worker.py RANK WORLD PORT OUT

Each check makes the same collective calls on every rank whatever its
result, so a wrong answer cannot hang the world.
"""
import os
import sys
import traceback
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import runtime as RT  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed.elastic import (make_elastic_mesh,  # noqa: E402
                                             reshard)
from repro_torch.distributed.pipeline import (gpipe_forward,  # noqa: E402
                                              split_layers_into_stages)
from repro_torch.kernels.lsm_attention import ops as KLA  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.serving import grow_dense, lsm_from_dense  # noqa: E402
from repro_torch.train import adamw_init, make_train_step  # noqa: E402

LR, WARMUP = 1e-3, 2


def train_batch(cfg, b=4, s=32, seed=0):
    """The sharded step's batch (shared with the test)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def moe_batch(cfg, b=4, s=32, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def lsm_cfg():
    return replace(get_config("deepseek-7b").smoke(), n_kv=2, n_heads=4)


def lsm_tokens(cfg, s=128, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (1, s + 1)).astype(np.int32)


def pipe_inputs(n_layers=16, d=32, n_micro=4, mb=8, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_layers, d, d)) * d ** -0.5).astype(np.float32)
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    return w, x


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


TRAIN_ARCHS = ("deepseek-7b", "qwen3-moe-30b-a3b")


def _train(arch):
    """One sharded train step of `arch` smoke on (2, 4); for a moe model
    the largest expert load over its capacity in the mesh dispatch."""
    cfg = get_config(arch).smoke()
    mesh = make_host_mesh(2, 4, device="cpu")
    model = lm.init_params(cfg, 0, device="cpu")
    opt = adamw_init(model)
    pspecs = SH.param_pspecs(cfg, model, mesh)
    ospecs = SH.zero1_pspecs(cfg, opt, mesh)
    batch = _tensors(train_batch(cfg))
    SH.distribute_model(model, mesh, pspecs)
    opt = SH.distribute(opt, mesh, ospecs)
    batch = SH.distribute(batch, mesh, SH.batch_pspecs(cfg, batch, mesh))
    loads = _loads(cfg)
    RT.set_axes(("data",), "model", mesh)
    try:
        with loads:
            step = make_train_step(cfg, base_lr=LR, warmup=WARMUP)
            model, opt, metrics = step(model, opt, batch)
    finally:
        RT.clear()
    params = dict(model.named_parameters())
    placed = all(params[k].placements == SH.placements(mesh, s)
                 for k, s in pspecs.items())
    placed &= all(opt.mu[k].placements == SH.placements(mesh, s)
                  and opt.nu[k].placements == SH.placements(mesh, s)
                  for k, s in ospecs.mu.items())
    out = {"placed": np.array(placed), "load": loads.worst()}
    for k in ("loss", "aux_loss", "grad_norm"):
        v = metrics[k]
        out[k] = (v.full_tensor() if RT.is_dtensor(v) else v).numpy()
    for k, p in params.items():
        out["p:" + k] = p.detach().full_tensor().numpy()
        out["mu:" + k] = opt.mu[k].full_tensor().numpy()
    return out


class _loads:
    """Under the context: each router call's largest expert load over the
    capacity of its token group, and the mesh branch's calls; `worst()`
    is the largest load over every rank (a collective)."""

    def __init__(self, cfg):
        self.cfg, self.loads, self.calls = cfg, [0.0], 0

    def __enter__(self):
        self.route, self.mesh = MOE._route, MOE._moe_mesh

        def route(cfg_, router, xt):
            probs, top_p, top_e = self.route(cfg_, router, xt)
            counts = torch.bincount(top_e.reshape(-1),
                                    minlength=self.cfg.n_experts)
            self.loads.append(int(counts.max()) / MOE.moe_capacity(
                self.cfg, xt.shape[0]))
            return probs, top_p, top_e

        def mesh_branch(*a):
            self.calls += 1
            return self.mesh(*a)
        MOE._route, MOE._moe_mesh = route, mesh_branch
        return self

    def __exit__(self, *exc):
        MOE._route, MOE._moe_mesh = self.route, self.mesh

    def worst(self):
        load = torch.tensor(max(self.loads))
        dist.all_reduce(load, op=dist.ReduceOp.MAX)
        return load.numpy()


def check_moe(rank):
    """(b) qwen3-moe smoke `logits_full` through the mesh branch on (2, 4);
    each rank records its experts' largest load against the capacity."""
    cfg = get_config("qwen3-moe-30b-a3b").smoke()
    mesh = make_host_mesh(2, 4, device="cpu")
    model = lm.init_params(cfg, 0, device="cpu")
    batch = _tensors(moe_batch(cfg))
    SH.distribute_model(model, mesh, SH.param_pspecs(cfg, model, mesh))
    batch = SH.distribute(batch, mesh, SH.batch_pspecs(cfg, batch, mesh))
    RT.set_axes(("data",), "model", mesh)
    try:
        with _loads(cfg) as loads:
            logits = lm.logits_full(cfg, model, batch)
    finally:
        RT.clear()
    return {"logits": logits.full_tensor().numpy(), "load": loads.worst(),
            "mesh_calls": np.array(loads.calls)}


def check_pipe(rank):
    """(c) GPipe over ("pipe",) of 8: L 16, D 32, 4 microbatches."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("pipe",))
    w, x = pipe_inputs()
    stages = split_layers_into_stages({"w": torch.from_numpy(w)}, 8)

    def stage_fn(p, h):
        for wl in p["w"]:
            h = torch.tanh(h @ wl)
        return h
    got = gpipe_forward(stage_fn, stages, torch.from_numpy(x), mesh)
    ref = got.clone()
    dist.broadcast(ref, 0)
    return {"out": got.numpy(), "same": np.array(torch.equal(got, ref))}


def _lsm_decode(mesh):
    cfg = lsm_cfg()
    model = lm.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(lsm_tokens(cfg))
    s = toks.shape[1] - 1
    _, dense = lm.prefill_step(cfg, model, {"tokens": toks[:, :s]})
    cache = lsm_from_dense(cfg, dense, s + 16)
    taken, real = [], lm.ATT._lsm_stats

    def stats(*a):
        taken.append(1)
        return real(*a)
    lm.ATT._lsm_stats = stats
    if mesh is not None:
        RT.set_axes(("data",), "model", mesh)
    try:
        logits, _ = lm.decode_step(cfg, model, toks[:, s], cache, kind="lsm")
    finally:
        RT.clear()
        lm.ATT._lsm_stats = real
    return logits.numpy(), len(taken)


def check_lsm(rank):
    """(d) one tiered decode step through the stats branch on (4, 2)."""
    mesh = make_host_mesh(4, 2, device="cpu")
    got, calls = _lsm_decode(mesh)
    single, single_calls = _lsm_decode(None)
    return {"logits": got, "single": single, "stats_calls": np.array(calls),
            "single_stats_calls": np.array(single_calls)}


def check_lsm_fault(rank):
    """(f) (d) with the stats merge's all-reduce(MAX) made the rank's local
    max: the collective still runs on a copy, the merge ignores it."""
    real = RT.all_reduce_

    def local_max(x, names, op=RT.SUM):
        if op == RT.MAX:
            real(x.clone(), names, op)
            return x
        return real(x, names, op)
    RT.all_reduce_ = local_max
    try:
        got, calls = _lsm_decode(make_host_mesh(4, 2, device="cpu"))
    finally:
        RT.all_reduce_ = real
    return {"logits": got, "stats_calls": np.array(calls)}


SERVE_PROMPT, SERVE_STEPS, SERVE_MAX = 64, 3, 128


def serve_tokens(cfg, b, seed=2):
    """A prompt and the tokens teacher-forced into the decode steps."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab,
                        (b, SERVE_PROMPT + SERVE_STEPS)).astype(np.int32)


def _full(t):
    return t.full_tensor() if RT.is_dtensor(t) else t


def _serve(b, kind, mesh):
    """`lsm_cfg()`: prefill of a batch-`b` prompt, its dense caches grown
    (dense) or tiered (lsm) to SERVE_MAX positions, then SERVE_STEPS
    teacher-forced decode steps. On `mesh` the model, the batch and the
    caches are DTensors laid out by the sharding rules (the prefill's
    caches by its own `_mesh_caches`, gathered to lay the decode caches
    out); with None, one process. -> the prefill's logits and K/V, each
    step's logits, the stats branch's calls, the kernel inputs' q
    placements and the decode caches' placements."""
    from torch.distributed.tensor import DTensor
    cfg = lsm_cfg()
    toks = serve_tokens(cfg, b)
    model = lm.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.from_numpy(toks[:, :SERVE_PROMPT])}
    stats, q_place = [], set()
    real_stats, real_per_rank = lm.ATT._lsm_stats, KLA._per_rank

    def count_stats(*a):
        stats.append(1)
        return real_stats(*a)

    def per_rank(entry, mesh_, tensors, *a, **k):
        if isinstance(tensors[0], DTensor):
            q_place.add(str(tensors[0].placements))
        return real_per_rank(entry, mesh_, tensors, *a, **k)
    lm.ATT._lsm_stats, KLA._per_rank = count_stats, per_rank
    if mesh is not None:
        SH.distribute_model(model, mesh, SH.param_pspecs(cfg, model, mesh))
        batch = SH.distribute(batch, mesh,
                              SH.batch_pspecs(cfg, batch, mesh))
        RT.set_axes(("data",), "model", mesh)
    try:
        logits, dense = lm.prefill_step(cfg, model, batch)
        out = {"prefill": _full(logits).numpy(),
               "prefill_k": _full(dense["k"]).numpy()}
        if mesh is not None:
            out["prefill_place"] = np.array(str(dense["k"].placements))
        dense = {k: _full(v) for k, v in dense.items()}
        grow = lsm_from_dense if kind == "lsm" else grow_dense
        caches = grow(cfg, dense, SERVE_MAX)
        if mesh is not None:
            caches = SH.distribute(caches, mesh,
                                   SH.cache_pspecs(cfg, caches, mesh))
            out["cache_place"] = np.array(
                [str(v.placements) for k, v in sorted(caches.items())])
        for i in range(SERVE_STEPS):
            tok = torch.from_numpy(toks[:, SERVE_PROMPT + i])
            if mesh is not None:
                tok = SH.distribute(tok, mesh, SH.P())
            logits, caches = lm.decode_step(cfg, model, tok, caches, kind)
            out[f"step{i}"] = _full(logits).numpy()
    finally:
        RT.clear()
        lm.ATT._lsm_stats, KLA._per_rank = real_stats, real_per_rank
    out["stats_calls"] = np.array(len(stats))
    out["q_place"] = np.array(sorted(q_place))
    return out


SERVE_CASES = {"dense_b2": (2, "dense"), "lsm_b2": (2, "lsm"),
               "lsm_b1": (1, "lsm")}


def check_serve(rank, case):
    """prefill + decode on (4, 2) and on one process: dense with the
    cache's positions over data (`_write_slot`); tiered at batch 2, the
    kernel branch with q's heads over model and the blocks over data
    (`_per_rank`, `select_blocks` per rank); tiered at batch 1, the
    stats branch on DTensor blocks (`_lsm_cold_stats`)."""
    b, kind = SERVE_CASES[case]
    got = _serve(b, kind, make_host_mesh(4, 2, device="cpu"))
    single = _serve(b, kind, None)
    got.update({"single:" + k: v for k, v in single.items()})
    return got


def check_moe_b1(rank):
    """`moe_ffn` of qwen3-moe smoke's first layer on (2, 4) at batch 1 (a
    batch DP does not divide: x whole on every DP rank) and on one
    process."""
    from torch.distributed.tensor import DTensor, Replicate
    cfg = get_config("qwen3-moe-30b-a3b").smoke()
    mesh = make_host_mesh(2, 4, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 8, cfg.d_model)).astype(np.float32))
    model = lm.init_params(cfg, 0, device="cpu")
    y1, aux1 = MOE.moe_ffn(cfg, model.layers[0].moe, x)
    SH.distribute_model(model, mesh, SH.param_pspecs(cfg, model, mesh))
    RT.set_axes(("data",), "model", mesh)
    try:
        with _loads(cfg) as loads:
            y, aux = MOE.moe_ffn(cfg, model.layers[0].moe, DTensor.from_local(
                x, mesh, [Replicate()] * 2, run_check=False))
    finally:
        RT.clear()
    return {"y": _full(y).numpy(), "aux": _full(aux).numpy(),
            "single_y": y1.numpy(), "single_aux": aux1.numpy(),
            "mesh_calls": np.array(loads.calls)}


def check_elastic(rank):
    """(e) a tree on (2, 4), gathered to the host, laid out again on the
    2 x 2 mesh of ranks 0-3."""
    tree = {"w": np.arange(64, dtype=np.float32).reshape(8, 8)}
    specs = {"w": SH.P("data", "model")}
    m1 = make_elastic_mesh(8, prefer_model=4, device="cpu")
    d1 = reshard(tree, m1, specs)
    host = {"w": d1["w"].full_tensor().numpy()}
    local1 = d1["w"].to_local().shape
    m2 = make_elastic_mesh(4, prefer_model=2, device="cpu")
    d2 = reshard(host, m2, specs)
    if rank >= 4:
        return None
    return {"w": d2["w"].full_tensor().numpy(),
            "local1": np.array(local1), "local2": np.array(
                d2["w"].to_local().shape),
            "mesh1": np.array(m1.mesh.shape), "mesh2": np.array(
                m2.mesh.shape)}


CHECKS = [*((f"train_{a}", lambda rank, a=a: _train(a)) for a in TRAIN_ARCHS),
          ("moe", check_moe), ("pipe", check_pipe),
          ("lsm", check_lsm), ("elastic", check_elastic),
          ("lsm_fault", check_lsm_fault),
          *((f"serve_{c}", lambda rank, c=c: check_serve(rank, c))
            for c in SERVE_CASES),
          ("moe_b1", check_moe_b1)]


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), Path(sys.argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    for name, fn in CHECKS:
        try:
            res = fn(rank)
        except Exception:
            (out / f"{name}.err.{rank}").write_text(traceback.format_exc())
            res = None
        if res is not None and (rank == 0 or name == "elastic"):
            tmp = out / f"{name}.{rank}.tmp.npz"
            np.savez(tmp, **res)
            os.replace(tmp, out / f"{name}.{rank}.npz")
        dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
