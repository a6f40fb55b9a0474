"""Multi-pod dry run on fake tensors: every (arch x shape) cell's step
traced over a fake world of 256 or 512 ranks, with its FLOPs, bytes,
collectives and memory per device (port of `repro.launch.dryrun`).

The reference lowers and compiles each cell for 512 forced host devices
and walks the HLO. Here each cell's inputs are `FakeTensor`s (shapes
and dtypes, no memory) laid out on a `DeviceMesh` over a fake process
group (`launch.mesh`, `fake=True`: collectives move nothing), and the
step runs once, eagerly, inside a `launch.cost.CostCounter`: the local
ops and collectives of rank 0 are counted as they are dispatched. The
decode cells reach the card's own path: `lsm_attention`'s entry points
take fake inputs by recording the kernel's work (`kernel_cost`) with
the counter.

    python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \\
        --shape decode_32k --mesh single

Records go to `build/dryrun_torch/<arch>__<shape>__<mesh>.json` (or
`--out`). A record holds the reference's fields: `hlo_flops_per_dev`,
`hlo_bytes_per_dev`, `collective_bytes_per_dev` and `collectives` (from
the counter, not an HLO walk: the names are kept so that the roofline
and report tools read both), `model_flops`, `memory` (argument, output
and temp bytes per device: the arguments' local shards, the results that
are not updated arguments, and the peak of live storages made during
the step less those results), `t_compute` / `t_memory` / `t_collective`
at the H100's peaks, `bottleneck`, `useful_flops_ratio`,
`roofline_fraction` and `decode_kind`; `lower_s` and `compile_s` are the
seconds to build the cell and to trace its step. Besides: `dot_flops`,
`kernels` (each hand-written kernel's calls, FLOPs and bytes),
`bytes_floor` (each parameter byte once, each kernel's bytes, the step's
results once) and `collective_note`.

The fake world is global state of the process: the CLI runs in its own
process, and tests run cells in a child process.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from dataclasses import replace
from pathlib import Path

import torch

from repro_torch.configs import all_arch_ids, get_config
from repro_torch.distributed import runtime as RT
from repro_torch.distributed import sharding as SH
from repro_torch.launch import cost
from repro_torch.launch.mesh import (axis_size, dp_axes,
                                     make_production_mesh)
from repro_torch.models import lm
from repro_torch.train import adamw_init, make_train_step

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="long", seq=524288, batch=1),
}

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"


def _shapes(params) -> dict:
    """{name: shape} of an `LM`'s parameters or a dict of tensors."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {k: tuple(v.shape) for k, v in params.items()}


def model_flops(cfg, kind: str, batch: int, seq: int, params) -> float:
    """6*N*D (train) / 2*N*D (inference), N_active for MoE; N leaves out
    the embedding and the head, as the reference's does."""
    shapes = _shapes(params)
    n_total = sum(math.prod(s) for s in shapes.values())
    n_embed = math.prod(shapes["embed"]) + math.prod(shapes["lm_head.weight"])
    n = n_total - n_embed
    if cfg.n_experts:
        expert = sum(math.prod(s) for k, s in shapes.items()
                     if ".moe." in k and k.rsplit(".", 1)[-1]
                     in ("w_gate", "w_up", "w_down"))
        n = n - expert + expert * cfg.moe_top_k / cfg.n_experts
    tokens = {"train": batch * seq, "prefill": batch * seq,
              "decode": batch, "long": batch}[kind]
    mult = 6 if kind == "train" else 2
    return float(mult * n * tokens)


# --------------------------------------------------------------------------
# cell construction
# --------------------------------------------------------------------------

def make_batch_specs(cfg, batch: int, seq: int, device) -> dict:
    """A batch's tensors (fake under a `FakeTensorMode`)."""
    i32 = dict(dtype=torch.int32, device=device)
    out = {"tokens": torch.zeros((batch, seq), **i32),
           "labels": torch.zeros((batch, seq), **i32)}
    if cfg.family == "encdec":
        out["frames"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                    dtype=getattr(torch, cfg.dtype),
                                    device=device)
    if cfg.mrope:
        out["positions3"] = torch.zeros((3, batch, seq), **i32)
    return out


def _spec(shape):
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(cfg, shape, device) -> dict:
    """Every input of the cell, built by the port's own constructors
    (`lm.init_params`, `adamw_init`, `init_decode_caches`); under a
    `FakeTensorMode` they are shapes only. `shape` is a name of SHAPES
    or a spec of its form (a `decode_kind` entry overrides the rule)."""
    spec = _spec(shape)
    b, s = spec["batch"], spec["seq"]
    params = lm.init_params(cfg, 0, device)
    if spec["kind"] == "train":
        return {"params": params, "opt": adamw_init(params),
                "batch": make_batch_specs(cfg, b, s, device)}
    if spec["kind"] == "prefill":
        batch = make_batch_specs(cfg, b, s, device)
        batch.pop("labels")
        return {"params": params, "batch": batch}
    kind = decode_kind(cfg, shape)
    return {"params": params,
            "token": torch.zeros((b,), dtype=torch.int32, device=device),
            "caches": lm.init_decode_caches(cfg, b, s, kind, device)}


def decode_kind(cfg, shape) -> str:
    if isinstance(shape, dict):
        return shape.get("decode_kind") or (
            "lsm" if shape["kind"] == "long" and cfg.family in (
                "dense", "vlm", "moe", "hybrid") else "dense")
    if shape == "long_500k" and cfg.family in ("dense", "vlm", "moe",
                                               "hybrid"):
        return "lsm"  # the paper's technique makes this cell lowerable
    return "dense"


def cell_skip_reason(cfg, shape_name: str) -> str | None:
    if shape_name == "long_500k" and cfg.family == "encdec":
        return ("whisper decoder is bounded at 448 positions by design; "
                "524k decode is out-of-family (DESIGN.md §4)")
    return None


def build_cell(cfg, shape, mesh, device):
    """Register the mesh's axes, lay the cell's inputs out by the
    sharding rules and -> (cfg as run, step(), its arguments). MoE
    routing is shard-local (`moe_dp_groups` = |DP|), as the reference
    sets it; `lsm_dp_groups` stays the config's (1: the global block
    selection, as in the reference). Call under a `FakeTensorMode` for a
    dry run."""
    RT.set_axes(dp_axes(mesh), "model", mesh)
    dpn = axis_size(mesh, *dp_axes(mesh))
    if cfg.n_experts:
        cfg = replace(cfg, moe_dp_groups=dpn)
    spec = _spec(shape)
    specs = input_specs(cfg, shape, device)
    model = specs["params"]
    SH.distribute_model(model, mesh, SH.param_pspecs(cfg, model, mesh))
    params = dict(model.named_parameters())

    if spec["kind"] == "train":
        step = make_train_step(cfg)
        opt = SH.distribute(specs["opt"], mesh,
                            SH.zero1_pspecs(cfg, specs["opt"], mesh))
        batch = SH.distribute(specs["batch"], mesh,
                              SH.batch_pspecs(cfg, specs["batch"], mesh))
        return cfg, (lambda: step(model, opt, batch)), (params, opt, batch)

    if spec["kind"] == "prefill":
        batch = SH.distribute(specs["batch"], mesh,
                              SH.batch_pspecs(cfg, specs["batch"], mesh))
        return cfg, (lambda: lm.prefill_step(cfg, model, batch)), \
            (params, batch)

    kind = decode_kind(cfg, shape)
    caches = SH.distribute(specs["caches"], mesh,
                           SH.cache_pspecs(cfg, specs["caches"], mesh))
    dp = dp_axes(mesh)
    b = specs["token"].shape[0]
    tok_spec = SH.P(dp if len(dp) > 1 else dp[0]) if b % dpn == 0 \
        else SH.P()
    token = SH.distribute(specs["token"], mesh, tok_spec)
    return cfg, (lambda: lm.decode_step(cfg, model, token, caches, kind)), \
        (params, token, caches)


def fake_device() -> torch.device:
    """The card's device type where there is one, else the CPU's: fake
    tensors take no memory on either."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _mesh_tag(mesh) -> str:
    sizes = [mesh.size(i) for i in range(mesh.ndim)]
    return {(16, 16): "pod16x16", (2, 16, 16): "pod2x16x16"}.get(
        tuple(sizes), "mesh" + "x".join(map(str, sizes)))


@contextlib.contextmanager
def _host_metadata():
    """DTensor works some shard offsets out with torch ops on small host
    tensors (`_compute_local_shape_and_global_offset`, a strided shard's
    `local_shard_size_and_offset`) and reads them back; under a
    `FakeTensorMode` those tensors would be fake and unreadable. Inside
    this context the two helpers run with the fake mode unset, and each
    answer is kept (a strided shard's is worked out from an index tensor
    the size of the dimension, asked again for every redistribution a
    3-D mesh plans)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _redistribute, _utils
    from torch.distributed.tensor import placement_types as PT

    def real(fn):
        memo = {}

        def run(*a, **k):
            try:
                key = (a, tuple(sorted(k.items())))
                return memo[key]
            except KeyError:
                pass
            except TypeError:       # an argument that cannot be a key
                key = None
            with unset_fake_temporarily():
                out = fn(*a, **k)
            if key is not None:
                memo[key] = out
            return out
        return run
    slots = [(_utils, "_compute_local_shape_and_global_offset"),
             (_redistribute, "_gen_transform_infos_non_cached")]
    if hasattr(PT, "_StridedShard"):
        slots.append((PT._StridedShard, "local_shard_size_and_offset"))
    saved = [(o, n, o.__dict__[n]) for o, n in slots if n in o.__dict__]
    for o, n, fn in saved:
        wrapped = real(getattr(o, n))
        setattr(o, n, staticmethod(wrapped)
                if isinstance(fn, staticmethod) else wrapped)
    try:
        yield
    finally:
        for o, n, fn in saved:
            setattr(o, n, fn)


def count_cell(cfg, shape, mesh, tracker=None) -> dict:
    """Trace one cell's step on fake tensors over `mesh` -> the counter's
    result with `memory`, the step's parameter bytes a device, the cfg
    as run and the seconds taken."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    try:
        with FakeTensorMode(), _host_metadata():
            cfg, fn, args = build_cell(cfg, shape, mesh, fake_device())
            t_build = time.time() - t0
            with cost.CostCounter(track_memory=True, fake_only=True,
                                  tracker=tracker) as c:
                c.mark_arguments(args)
                out = fn()
            t_trace = time.time() - t0 - t_build
            param_bytes = sum(cost.nbytes(cost._local(p))
                              for p in args[0].values())
            out_bytes = c.new_storages(out)
    finally:
        RT.clear()
    res = c.result()
    res.update(
        cfg=cfg, lower_s=t_build, compile_s=t_trace, param_bytes=param_bytes,
        top_collectives=c.top_collectives(),
        memory={"argument_size_in_bytes": c.argument_bytes,
                "output_size_in_bytes": out_bytes,
                "temp_size_in_bytes": max(0, c.peak - out_bytes),
                "peak_size_in_bytes": c.argument_bytes + c.peak})
    return res


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             force: bool = False, verbose: bool = True, *, spec=None,
             mesh=None, out_dir=None) -> dict:
    """Trace one cell and write its record (a cached record without an
    error is returned as it is unless `force`). `spec` replaces
    SHAPES[shape_name] (a dict of its form) and `mesh` the production
    mesh (any mesh over a fake world)."""
    out_dir = Path(out_dir or RESULTS_DIR)
    os.makedirs(out_dir, exist_ok=True)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, fake=True,
                                    device=fake_device())
    mesh_tag = _mesh_tag(mesh)
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_tag}.json"
    if out_path.exists() and not force:
        cached = json.loads(out_path.read_text())
        if "error" not in cached:
            return cached

    cfg = get_config(arch)
    chips = mesh.size()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
           "chips": chips}
    skip = cell_skip_reason(cfg, shape_name)
    if skip:
        rec["skipped"] = skip
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    shape = shape_name if spec is None else spec
    spec = _spec(shape)
    try:
        res = count_cell(cfg, shape, mesh)
        run_cfg = res["cfg"]
        mf = model_flops(run_cfg, spec["kind"], spec["batch"], spec["seq"],
                         lm.LM(run_cfg, torch.device("meta")))
        flops, n_bytes = res["flops"], res["bytes"]
        coll = res["collective_bytes"]
        widest = max(mesh.size(i) for i in range(mesh.ndim))
        rec.update({
            "lower_s": round(res["lower_s"], 1),
            "compile_s": round(res["compile_s"], 1),
            "hlo_flops_per_dev": flops, "hlo_bytes_per_dev": n_bytes,
            "collective_bytes_per_dev": coll,
            "collectives": res["collectives"],
            "collective_counts": res["collective_counts"],
            "dot_flops_per_dev": res["dot_flops"],
            "kernels": res["kernels"],
            "model_flops": mf,
            "memory": res["memory"],
            "bytes_floor": (res["param_bytes"]
                            + sum(k["bytes"] for k in res["kernels"].values())
                            + res["memory"]["output_size_in_bytes"]),
            # roofline terms, seconds (per-device work / per-card rate)
            "t_compute": flops / cost.peak_flops(run_cfg.dtype),
            "t_memory": n_bytes / cost.HBM_BYTES_PER_S,
            "t_collective": coll / cost.NVLINK_BYTES_PER_S,
            "collective_note": (
                f"t_collective at NVLink's {cost.NVLINK_BYTES_PER_S:.3g} B/s"
                f" a card; the widest mesh axis here spans {widest} ranks: "
                f"a group wider than {cost.NVLINK_DOMAIN} cards crosses "
                "hosts, where NVLink's rate does not hold and the "
                "network's is not modelled"),
            "useful_flops_ratio": (mf / (flops * chips)) if flops else None,
            "decode_kind": (decode_kind(cfg, shape)
                            if spec["kind"] in ("decode", "long") else None),
        })
        terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
                 "collective": rec["t_collective"]}
        rec["bottleneck"] = max(terms, key=terms.get)
        rec["roofline_fraction"] = (
            max(terms.values()) and terms["compute"] / max(terms.values()))
        rec["top_collectives"] = res["top_collectives"][:5]
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"FAILED {arch} {shape_name} {mesh_tag}: {rec['error']}")

    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all",
                    choices=["all"] + list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None,
                    help=f"records directory (default {RESULTS_DIR})")
    args = ap.parse_args(argv)

    archs = all_arch_ids() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    t0 = time.time()
    n_ok = n_fail = n_skip = 0
    for mp in meshes:
        mesh = make_production_mesh(multi_pod=mp, fake=True,
                                    device=fake_device())
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mp, force=args.force,
                               mesh=mesh, out_dir=args.out)
                if "error" in rec:
                    n_fail, status = n_fail + 1, "FAIL"
                elif "skipped" in rec:
                    n_skip, status = n_skip + 1, "SKIP"
                else:
                    n_ok, status = n_ok + 1, "ok"
                print(f"[{time.time()-t0:7.1f}s] {arch:24s} {shape:12s} "
                      f"{'2x16x16' if mp else '16x16':8s} {status}",
                      flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
