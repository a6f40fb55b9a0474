#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py [--seed N] [--writes N] [--parent-bloom CU]

Phases, in order; any failure raises and exits non-zero:

  device   — a CUDA card is required; prints its name, count and power
             limit (nvidia-smi).
  build    — compiles the five CUDA kernels from `src/repro_torch/csrc`
             with nvcc for sm_90a, one nvcc process each, in parallel.
  kernels  — runs each kernel and its plain PyTorch version on the card
             at the shapes of the paper-geometry main path, requires them
             bitwise equal, and times kernel, plain version and the one
             library call that computes the same function: device time
             per call from torch.profiler after warm-up, and the
             wrapper's wall time between CUDA events beside it. Bounds
             count each byte the function needs once. bloom_probe runs
             as the read path launches it, once a lookup batch over both
             disk levels, and at level 1 alone, three levels sized as
             the adaptive tuner sizes them (k 6, 10, 13, bits < 32 W),
             every pair a member, one run and Q = 4,093, 1,024 and 256,
             beside one gather of the words its chains need (a floor of
             its reads); with --parent-bloom, a previous bloom_probe.cu
             (one launch a level) in turns with it; then two planted
             faults (a member's last probe cleared at level 0, a
             member's first at level 1) must turn that pair to a miss
             and leave the other level alone. heap_merge runs at
             both shapes it launches at (the buffer flush, 50 x 800, and
             the level spill, 20 x 40,448) and at a level-1 spill
             (20 x 808,960, its samples searched in place): the k-way
             kernel beside the tournament of round launches it replaced,
             each bitwise equal to the plain version. range_merge runs
             at the scan rows of the main path (32 x 512 lanes, 91
             segments: one launch) and at rows of 16,384 lanes (a split
             and a merge launch), beside the rounds of the round kernel
             it replaced, both bitwise equal to the plain version.
             fence_lookup runs at level 1 (20 runs, 1,580 fences each,
             staged whole) and at 4 runs of level_cap(2) (632,000
             fences, ~5.2 GB of keys built on the card; every 64th fence
             staged). The adaptive engine's shapes too: bloom_probe at
             the WRITE and READ allocations of levels 0-1 and READ with
             level 0 left out, fence_lookup at stride 2 on levels 1 and
             0 (a partial last page, pinned), heap_merge at the read
             allocation's 1 x 800, 1 x 40,448 and 2 x 40,448.
  main     — the engine at the paper's Table 1 baseline
             (`paper_params(merge_budget=1, range_cand=512)`) on the card:
             8M writes and 800K interleaved deletes, 1M lookups, 2048
             range scans, 2048 aggregates, every answer checked against a
             numpy oracle; all four kernels must have launched,
             bloom_probe once a lookup batch (256) and range_merge once a
             scan or aggregate batch, no round kernel
             (heap_merge's or range_merge's); the heap_merge launches
             counted by merge shape (flush, spill).
  profile  — a short window of each main-path flow under torch.profiler:
             device time by kernel and the device-busy share.
  cascade  — the scaled geometry through deepest-level compactions with
             annihilation, checked against the dict oracle.
  adaptive — the adaptive tuner at the paper's widths (max_levels 4) with
             the reference's shifting policy, through the port's
             `make_shifting` stream (`repro_torch.bench.workloads`,
             byte-identical to the reference's; 1M writes, 4M lookups,
             every other lookup batch sparse, 32 scans), every answer
             against the numpy oracle: WRITE reached in phase 1, READ at
             the end, >= 2 retunes, >= 1 probe sample, level 0 folded
             empty and left out of every later bloom_probe call (levels
             a launch printed, held to the levels the state holds runs
             in);
             lookups/s by allocation and search, each RETUNE's wall
             time and, profiled apart, the card's time of its rebuild,
             a rebuild of the final filters, and each flow's
             device-busy share.
  tape     — 512 mixed windows through run_tape on that engine (oracle-
             exact, voluntary_steps(1) between windows; writes of 1-16
             keys, see TAPE_WRITE_MAX), then 256 windows with writes of
             1-800 keys over 65,536 keys through run_tape and op by op on
             two engines at the cascade's geometry, answers equal and
             exact, >= 1 compaction; segments, and blocking reads a
             window by call site (CUDA sync debug mode).
  durable  — the main phase's geometry with a WAL under build/durable
             (its filesystem printed), fsynced at every call: 2M inserts
             and 200K deletes in calls of 800 keys, each call to a
             volatile engine and then to the durable one; write ops/s
             of each, host ms a call, fsync ms a sync, WAL bytes an op; a
             snapshot after the first 1M writes (ms, bytes); the engine
             dropped without close() and the WAL cut inside its last
             record; `SLSM.restore` on the card (restore_us, replayed
             records, replay ops/s), then 1M lookups (half absent), 2,048
             scans and 2,048 aggregates, every answer against the oracle
             of the durable prefix. Then the killed writer: a child
             process writes (insert and delete calls, run_tape windows,
             lookups) through a durable adaptive engine at the cascade's
             geometry and prints each call's acknowledgement; SIGKILLed
             after 24-48 of them, its directory restores on the card: the
             WAL's write records are a prefix of its stream covering every
             acknowledged call, a RETUNE is replayed, and every answer
             equals the oracle of that prefix.
  sharded  — the sharded engine (`ShardedSLSM`, 4 shards) at the paper's
             widths with max_levels 2 (every tier of every shard is
             allocated: ~23.1 GB of stacked state, peak memory printed):
             4M inserts and 400K deletes in calls of 800 keys, 1M
             lookups (half absent) in batches of 4,096, 2,048 scans and
             2,048 aggregates in batches of 32, 64 run_tape windows with
             writes of 1-800 keys, every answer against the numpy
             oracle; every shard must spill. bloom_probe launches once a
             lookup batch (and tape lookup slot), fence_lookup at most
             once a level a batch, range_merge once a scan or aggregate
             batch (and tape range slot), heap_merge twice a masked
             merge step whatever the shards in its mask; write ops/s,
             lookups/s, scans/s, aggregates/s and a lookup window's
             device-busy share. Then each engine kernel at the path's
             shard-batched shapes (bloom_probe over both levels of the
             fleet's filters with 4 x 1,024 keys, fence_lookup over the
             fleet's deepest level, heap_merge over a batch of 4 spills
             of 20 x 40,448, range_merge over 4 x 32 rows of 512 lanes):
             one launch (two for heap_merge) bitwise equal to the plain
             version and to one single-tree launch a shard, timed beside
             those four launches; the records join the kernels' `cases`.
  sharded cascade — the cascade's geometry on 4 shards with adaptive
             tuning and a WAL under build/sharded_cascade: deepest-level
             compactions with annihilation in two shards or more, a
             lockstep RETUNE, a snapshot halfway, the engine dropped
             without close() and its WAL cut inside the last record,
             `ShardedSLSM.restore` on the card, every answer against the
             oracle of the durable prefix.
  replicated — a durable leader at the paper's widths with max_levels 2
             (WAL fsynced under build/replicated) under a quorum-1
             `Leader` on a fake clock, two followers on the card, a
             leader and a follower `Server`, driven by `closed_loop`
             (16 clients, 4 of them on the follower): 1M written keys in
             requests of 1-800 (a tenth deletes), >= 200K looked up in
             requests of 1-64, ranges of 1-32 windows. Every leader
             reply against the oracle at its point in the stream, every
             follower reply against the oracle of the follower's applied
             prefix, every acknowledged write at or below quorum_seqno()
             and in a follower's log; after `converge` the followers'
             logs byte-identical to the leader's and 1M lookups, 2,048
             scans and 2,048 aggregates bitwise the leader's (one
             bloom_probe launch a lookup batch, one range_merge a scan
             batch); then the lease expires: exactly follower 0
             promotes, the old leader is fenced by the fence ack (its
             held write fails), the promoted leader answers as the
             oracle of its WAL's writes, and with follower 1 and a fresh
             bootstrap in the old leader's place it acknowledges writes
             at epoch 1. Prints acknowledged writes/s, reply p50/p99 by
             kind, windows, blocking reads a window, follower apply
             rates, lag, fsync ms, promote and bootstrap ms, and the
             device-busy share of a leader window and a follower apply.
  replica kill — a leader `Server` at the cascade's geometry in a child
             process ships over a localhost socket to a follower on the
             card; SIGKILLed after 200-400 applied records, the follower
             promotes and answers bitwise as a fresh engine fed the
             write records of its own WAL, which hold every window the
             child acknowledged, and takes writes at epoch 1.
             Launches are counted from 0 just before, and read just
             after, the main phase, the adaptive engine's traffic (after
             its warm-up), its tape windows, the scaled run_tape
             engine's windows (not the op-by-op engine's), the durable
             restore with its reads, the sharded engine's traffic
             (after its warm-up), the replicated leader and followers
             apart, the replica kill's follower, and each run of the
             scenarios phase (below); a path that never launches one of
             the engine's four kernels fails.
  scenarios — the paper's workload families (`repro_torch.bench`) through
             the engine at the paper's widths, one fresh engine a run,
             each the main phase's baseline with only its reference
             scenario's knob: sequential, zipfian, delete_heavy,
             range_scan (max_range 8,192 and range_cand 16,384: no
             window truncated), uniform, sweep_policy_leveling (at most
             2 runs a level), sweep_merge_budget_0, sweep_eps_0p1 and
             sweep_eps_1e-05, 900K inserts each (zipfian 2.6M:
             overwrites fold in the staging buffer; leveling 750K at
             max_levels 2: its level 2 would be ~115 GB; delete_heavy's
             ~350K deletes after them) in calls of 4 * Rn, a drain, the
             workload's lookups in batches of 4,096, and 64 windows
             (range_scan's own, else each spanning 128 inserted keys,
             zipfian's 4) as scans and aggregates in batches of 32; then
             the serving stream through `Server` and `closed_loop`:
             10,000 ops at 1 client on an empty store, every reply
             against the oracle in stream order, and 50,000 ops at 16
             clients on a store preloaded with 790,000 keys, whose
             writes flush into a full level 0 and spill into disk level
             1, every reply against the oracle at its point in the
             dispatch order; then make_kv_workload's normal (negative
             keys), zipf and cluster-lookup kinds, 200K inserts each, at
             the KV service example's geometry. Every answer against
             the oracle; each engine run and the 16-client point reach
             disk level 1 and launch all four engine kernels, no round
             kernel (the one-client point: those its state calls for).
             A line a run: write ops/s, lookups/s, scans/s,
             aggregates/s, levels and runs a level, flushes, spills and
             compactions, launches (heap_merge by shape), peak memory,
             the measured Bloom FP rate (the disk runs' filters on
             absent keys) beside eps; bloom_probe timed on the eps
             runs' own filters, heap_merge at leveling's 2-run spill
             and on its deepest level's compaction input, its bound
             counted over the filled lanes beside all lanes' (records
             joining the kernels' `cases`).
  lsm_kernel — the attention kernel against its plain version at the LM
             path's shapes: the tiered cache read in place (bf16 and f32;
             every row it must not read is NaN), the dense cache of
             lm_agree by lengths, and the Pallas contract (K/V and a
             bitmap) on the gathered tiered input; bf16 rtol 8e-3, one
             ulp, and atol 1e-3 of the largest output; f32 atol 1e-5 rtol
             1e-4. Planted faults must fail that check: the plain
             version with every 32nd position dropped, and for the
             tiered cases the kernel with the top selected block marked
             not ok. Timed beside its plain version,
             `F.scaled_dot_product_attention` on the (gathered) K/V and,
             tiered, the path it replaces (gather, concatenation, bitmap,
             kernel).
  lm_serve — Phi-4-mini 3.8B at full width (bf16, seeded random
             weights): `generate(kind="lsm")` for 2 x 24,576-token
             prompts and 32 new tokens; the kernel launched once per
             layer per step, every logit finite, 23 cold blocks and 1,055
             hot tokens at the end; prefill and decode times, the
             device-busy share of a decode window, peak memory.
  lm_seal  — on that cache: fill the hot window, seal, check the new
             block, its summary and the counters, and hold layer 0's
             kernel output of the next step against the plain version.
             (The tiered and dense decode paths launch the kernel with no
             gather, concatenation or bitmap in front of it.)
  lm_agree — 2 x 8,192-token prompts (7 cold blocks <= topk 16): tiered
             and dense decode, teacher-forced, agree to a relative L2 of
             2e-2 in the logits at every step, and layer 0's attention
             outputs to the kernel tolerance; with the top selected block
             masked out, layer 0 must fail that tolerance.
  moe_kernel — the attention kernel against its plain version at the two
             moe decode shapes (head dim 64): Granite-MoE-1B-A400M (16
             heads, kv 8: a query group of 2, one pass) and Qwen3-30B-A3B
             (32 heads, kv 4: a group of 8, two passes of 4), the tiered
             bf16 case of lsm_kernel with its planted faults, tolerance,
             timings and bound; the records join lsm_attention's cases.
  moe_serve — Granite-MoE-1B-A400M at full width and depth (bf16, seeded
             random weights), as lm_serve: 2 x 24,576-token prompts, 32
             new tokens, exactly 24 x 31 = 744 kernel launches, all in
             place on the tiered cache, 23 cold blocks, 1,055 hot
             tokens, finite logits, tokens in range; decode ms a step,
             tokens/s, prefill s, peak memory, a decode window's
             device-busy share.
  moe_agree — Qwen3-30B-A3B at full width and depth (bf16, seeded random
             weights, ~30.1 B parameters), as lm_agree: 2 x 8,192-token
             prompts, tiered vs dense logits rel L2 <= 2e-2, layer 0 at
             the kernel tolerance, the masked-block control; then a
             profiled decode window on the tiered cache; peak memory.
  hybrid_kernel — the attention kernel at Zamba2-1.2B's shared-block
             shape (32 heads, kv 32, head dim 64: a query group of 1, one
             head a pass), the tiered bf16 case of lsm_kernel with its
             planted faults; the record joins lsm_attention's cases.
  ssm_serve — Mamba2-370M at full width and depth (bf16, seeded random
             weights; attention-free, so no kernel launches and the
             counters must stay 0): `generate` for 2 x 16,384-token
             prompts and 32 new tokens (the state decode), finite logits,
             tokens in range; then teacher-forced: prefill 16,128 tokens,
             decode the next 16 given ones, each step's logits against
             `forward` over all 16,384 tokens at rel L2 <= 2e-2 (or 3x
             that step's bf16 floor, the bf16 forward against an f32
             forward of the same weights, if that is more), and the same
             check in f32 at rel L2 <= 1e-3 (the sharp one); decode ms
             a step, prefill s, a decode window's device-busy share, peak
             memory.
  hybrid_serve — Zamba2-1.2B at full width and depth (bf16, seeded
             random weights; 38 Mamba-2 blocks, one shared attention
             block after every 6th, each of its 6 applications with its
             own tiered KV cache), as lm_serve: 2 x 24,576-token prompts,
             32 new tokens, exactly 6 x 31 = 186 kernel launches, all in
             place, 23 cold blocks and 1,055 hot tokens an application;
             then lm_seal on the shared stack.
  hybrid_agree — the same model as lm_agree: 2 x 8,192-token prompts,
             the first application at the kernel tolerance at every step,
             the masked-block control. In bf16 a step's tiered vs dense
             logits rel L2 <= 2e-2 or 3x that step's dense floor (the
             dense step with the plain attention against the kernel's) if
             that is more — the 38 Mamba-2 blocks carry an ulp of
             attention difference into their state, and a masked block
             moves the logits about as much. So the same phase runs on an
             f32 copy of the weights (hybrid_agree f32): tiered vs dense
             rel L2 <= 1e-3 at every step, and the masked-block control's
             logits must exceed 1e-3.
  vlm_kernel — the attention kernel at Qwen2-VL-7B's tiered shape (28
             heads, kv 4, head dim 128: a query group of 7, seven passes
             of one head), the tiered bf16 case of lsm_kernel with its
             planted faults; the record joins lsm_attention's cases.
  vlm_serve — Qwen2-VL-7B at full width and depth (bf16, seeded random
             weights, ~7.6 B parameters; text `positions3`, three equal
             M-RoPE streams), as lm_serve: 2 x 24,576-token prompts, 32
             new tokens, exactly 28 x 31 = 868 kernel launches, all in
             place, 23 cold blocks and 1,055 hot tokens; then lm_seal.
  vlm_agree — the same model as lm_agree (2 x 8,192-token prompts):
             tiered (RoPE) vs dense (M-RoPE, equal streams) logits rel L2
             <= 2e-2 or 3x that step's dense floor if that is more, layer
             0 at the kernel tolerance, the masked-block control.
  encdec_kernel — the attention kernel by lengths at Whisper-tiny's two
             decode shapes (6 heads, kv 6, head dim 64: a group of 1):
             the decoder's self-attention cache (456 positions, lengths
             224 and 448) and its cross-attention over the 1,500 encoder
             positions, bf16, with the planted fault, timings and bound.
  encdec_serve — Whisper-tiny at full width and depth (bf16, seeded
             random weights, seeded frames (2, 1500, 384) in bf16):
             `generate(kind="dense")` for 2 x 8-token prompts and 440 new
             tokens (the 448-position table filled), exactly 8 kernel
             launches a step (4 self-attention, 4 cross-attention),
             finite logits, tokens in range; `generate(kind="lsm")` must
             raise ValueError; then teacher-forced: prefill 8 tokens,
             decode the next 440 given ones, each step's logits against
             `forward` over all 448 at rel L2 <= 2e-2 (or 3x that step's
             bf16 floor if that is more), and on an f32 copy at rel L2
             <= 1e-3; decode ms a step, the encoder's ms, a decode
             window's device-busy share.
  train    — Granite-MoE-1B-A400M at full width and depth (bf16, seeded
             random weights, ~1.38 B parameters, AdamW's f32 moments):
             8 steps of `make_train_step(base_lr=1e-3, warmup=2)` on one
             repeated `TokenStream(seed=0)` batch of 4 x 256 tokens;
             every loss finite, the last below the first, no counted
             kernel launched (training runs plain PyTorch, as the
             reference trains through plain jnp); step ms between CUDA
             events (the first apart), tokens/s, peak memory, one more
             step's device-busy share.
  train_agree — Phi-4-mini at full width, depth cut to 2, f32, TF32 off
             (~1.43 B parameters): one train step on the card and one on
             the CPU from the same weights, loss and grad norm within
             1e-5 relative, every parameter's gradient (the step's first
             AdamW moment) within 1e-4 relative plus 1e-5 of the leaf's
             largest, every updated parameter within 2 * lr + 1e-6;
             accum_steps 4 against 1 on the card at the same bounds.
  mesh     — `distributed/` on a one-rank NCCL group and a (1, 1)
             (data, model) mesh on the card (NCCL places no two ranks on
             one card; the multi-rank checks run in the CPU tests), each
             check counting that its mesh branch ran, with its seconds
             and peak memory: `moe_mesh` (Granite-MoE at full width and
             depth, bf16, DTensor parameters: `logits_full` of 2 x 1,024
             tokens through `moe_ffn`'s mesh branch against the
             single-device path, layer 0's FFN output at the kernel
             tolerance, logits rel L2 <= 2e-2), `lsm_mesh` (Phi-4-mini at
             full width and depth, b = 1, an 8,192-token prompt, 8
             teacher-forced tiered decode steps through the sharded-stats
             branch against the single-device `lsm_attention` branch:
             logits rel L2 <= 2e-2 or 3x that step's dense floor, layer
             0's attention at the kernel tolerance, which the branch
             with its top selected block masked must fail),
             `train_mesh` (Granite-MoE at full width and depth in f32,
             TF32 off: one step with DTensor parameters, ZeRO-1 moments
             and the batch laid out by the sharding rules against the
             same step with no mesh, at train_agree's bounds) and
             `compress` (int8 error-feedback roundtrip of a full-size
             leaf, bitwise the CPU's).
  mirrors  — tools/recovery_smoke_torch.py, tools/replication_smoke_torch.py
             (and its --partition mode), examples/failover_demo_torch.py,
             and the examples quickstart_torch.py,
             long_context_serve_torch.py, train_lm_torch.py and
             kv_store_service_torch.py, as eight concurrent subprocesses
             on the card, started before the mesh phase (their output in
             build/scripts/): exit 0 and the line each must print (a
             twin's, its reference's success line).
  dryrun   — `repro_torch.launch.dryrun` in a child process (started
             with the train_agree phase, so that its CPU trace runs beside
             value checks, not beside a phase that measures a rate; its
             output in build/dryrun/) on fake
             CUDA tensors over a fake (1, 1) world, at two shapes
             measured above, its estimate read here: the `train`
             step and `lm_serve`'s tiered decode step. The estimate's
             argument bytes must equal the real weights, AdamW state and
             batch, its peak be within 25% of `train`'s
             max_memory_allocated; `train_mfu` (model FLOPs / step time
             / the bf16 peak) and `decode_hbm_share` (bytes_floor /
             decode ms a step / HBM's rate) are printed beside the card
             and must be finite and at most 1.
             The kernel's launches are counted by path (lm_serve,
             lm_agree, moe_serve, moe_agree, hybrid_serve, hybrid_agree,
             hybrid_agree_f32, vlm_serve, vlm_agree, encdec_serve,
             lsm_mesh). Each phase's seconds are printed (`phase <name>:
             <s> s`).

The last two lines of standard output are the kernels' JSON record and
the device record; nothing of JAX or of the reference package is used.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
LOOKUP_BATCH = 4096
SCAN_BATCH = 32
KEY_BITS = 24
LM_ARCH = "phi4-mini-3.8b"
MOE_SERVE_ARCH = "granite-moe-1b-a400m"  # full width and depth
MOE_AGREE_ARCH = "qwen3-moe-30b-a3b"     # full width and depth, ~60.1 GB
SSM_ARCH = "mamba2-370m"        # full width and depth, no KV cache
HYBRID_ARCH = "zamba2-1.2b"     # full width and depth, 6 shared-block caches
VLM_ARCH = "qwen2-vl-7b"        # full width and depth, ~15.2 GB in bf16
ENCDEC_ARCH = "whisper-tiny"    # full width and depth
ENCDEC_PROMPT, ENCDEC_STEPS = 8, 440     # fills the 448 learned positions
SSM_PROMPT = 16_384             # 64 SSD chunks of 256
SSM_CHECK_STEPS = 16            # teacher-forced steps after S - 256 tokens
F32_LIMIT = 1e-3                # f32 rel L2 of two decodes' logits
SERVE_PROMPT, SERVE_STEPS = 24_576, 32   # 23 cold blocks + 1,024 hot
SERVE_HOT = 1_056               # hot tokens a serve step attends at first
AGREE_PROMPT, AGREE_STEPS = 8_192, 8     # 7 cold blocks <= topk 16
AGREE_LIMIT = 2e-2              # rel L2 of two decodes' logits, or FLOOR_X
FLOOR_X = 3                     # times a bf16 floor that reaches it
FENCE_DEEP_RUNS = 4             # runs of level_cap(2) in the deep fence case
RANGE_WIDE = 16_384             # scan rows wider than one merge tile
ADAPTIVE_EPS = (2 ** -6, 1e-3, 2 ** -13)   # k = 6, 10, 13 by level
ADAPTIVE_DEEP_CUT = 16          # level 2's runs cut to level_cap(2) / 16
ADAPTIVE_N = 1_000_000          # writes of the adaptive phase's stream
TRAIN_ARCH = "granite-moe-1b-a400m"     # trained at full width and depth
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 256, 8
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
AGREE_TRAIN_ARCH = "phi4-mini-3.8b"     # full width, depth cut to 2, f32
AGREE_TRAIN_LAYERS = 2
AGREE_TRAIN_BATCH, AGREE_TRAIN_SEQ = 4, 64
TRAIN_REL = 1e-5                # loss and grad norm, card against CPU
# each parameter's gradient, card against CPU: rtol as the CPU parity
# tests', atol this share of the leaf's largest |gradient| (f32 sums over
# widths of 3,072-8,192 in another order, entries left near zero by
# cancellation carry the error of the leaf's scale)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-5


def log(*parts) -> None:
    print(*parts, flush=True)


@contextlib.contextmanager
def phase(name: str):
    """Logs the seconds the phase `name` took, on its own line."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")


def bound_ms(name: str, **shape) -> float:
    """The least time (ms) one call of kernel `name` could take on the
    card, from `launch.cost.kernel_cost` at `shape` and the card's peaks
    (`launch.cost.bound_ms`)."""
    from repro_torch.launch import cost
    return cost.bound_ms(*cost.kernel_cost(name, **shape))[0]


def wall_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of fn() over `iters` back-to-back calls between two CUDA
    events: the device work plus the host's gaps between launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def device_us_by_name(prof):
    """Device time (µs) of every kernel and copy a profile traced, by name
    (`trace_markers`' spin kernels left out)."""
    import collections

    from torch.autograd import DeviceType
    by_name = collections.Counter()
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and MARKER_NAME not in ev.name:
            by_name[ev.name] += ev.time_range.elapsed_us()
    return by_name


# the tracer drops the first one to three device events after it starts
# (seen on an H100: a sort's first copy, fill and memset, the first split
# and merge of a k-way merge): a trace opens with short spin kernels that
# take the loss, and their events are left out
TRACE_MARKERS = 8
MARKER_CYCLES = 20_000           # ~10 µs each at the H100's clock
MARKER_NAME = "spin_kernel"      # in the name of torch.cuda._sleep's kernel


def trace_markers() -> None:
    """Launch TRACE_MARKERS spin kernels and wait for them (inside a
    trace, before the calls it times)."""
    import torch
    for _ in range(TRACE_MARKERS):
        torch.cuda._sleep(MARKER_CYCLES)
    torch.cuda.synchronize()


def device_ms_by_name(fn, iters: int, warmup: int = 2) -> dict:
    """Mean device time (ms) a call of fn() over `iters` calls, by kernel
    or copy name, as torch.profiler traces them on the card. Every call
    launches the same kernels, so each name should be traced a multiple
    of `iters` times. The tracer drops the first events it sees (1 to 3,
    seen on an H100), which would read the time low: each trace opens
    with `trace_markers()`, whose events are left out. A trace that is
    still not whole is taken again, and if none of 3 is, each
    name's time per traced event over the 3 is multiplied by its
    launches a call — the most events a try traced over `iters`, rounded
    up, since a trace only loses events — and the counts are logged. If
    all 3 traces are empty (the tracer can lose every event of a call, as
    on an H100 once in kernel_phase), the calls are timed with CUDA events
    instead (`wall_ms`, which also counts the host's gaps between
    launches), under the one name "cuda_events", and that is logged."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    us, events, most = (collections.Counter() for _ in range(3))
    for _ in range(3):      # the tracer now and then drops events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trace_markers()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = device_us_by_name(prof)
        traced = collections.Counter(ev.name for ev in prof.events()
                                     if ev.device_type == DeviceType.CUDA
                                     and MARKER_NAME not in ev.name)
        if traced and all(n % iters == 0 for n in traced.values()):
            return {k: t / 1e3 / iters for k, t in by_name.items()}
        us.update(by_name)
        events.update(traced)
        most |= traced
    if not events:
        ms = wall_ms(fn, iters, warmup=0)
        log(f"profiler: no device event traced in 3 tries of {iters} calls; "
            f"timed with CUDA events instead: {ms} ms a call")
        return {"cuda_events": ms}
    log(f"profiler: no whole trace of {iters} calls in 3 tries; the most "
        "counted " + json.dumps({kernel_name(k): n for k, n in most.items()}))
    return {k: us[k] / 1e3 / events[k] * -(-most[k] // iters) for k in us}


def kernel_name(name: str) -> str:
    """A traced kernel's function name without its signature."""
    m = re.search(r"(\w+)[<(]", name)
    return m.group(1) if m else name[:40]


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` calls: the summed durations of
    the kernels and copies torch.profiler traces on the card, so the host's
    gaps between launches do not count."""
    return sum(device_ms_by_name(fn, iters, warmup).values())


def search_reads(rows, base, n: int, x, right: bool):
    """The binary search of common.cuh (`lower_bound`, or `upper_bound`
    when right) of x (D, Q) in rows[d, base : base + n], run in lockstep:
    -> (result (D, Q), flat indices d * width + i of every element read)."""
    import torch
    d_n, width = rows.shape
    lo = torch.zeros_like(x, dtype=torch.int64)
    hi = torch.full_like(lo, n)
    row0 = torch.arange(d_n, device=rows.device)[:, None] * width
    reads = []
    while bool((act := lo < hi).any()):
        mid = (lo + hi) >> 1
        at = (base + mid).clamp(max=width - 1)
        v = rows.gather(1, at)
        go = (v <= x) if right else (v < x)
        reads.append((row0 + at)[act])
        lo = torch.where(act & go, mid + 1, lo)
        hi = torch.where(act & ~go, mid, hi)
    return lo, torch.cat(reads)


def max_abs_err(got, want) -> int:
    import torch
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            err = max(err, int((g.long() - w.long()).abs().max()))
            err = max(err, 1)
    return err


# --------------------------------------------------------------------------
# kernels phase
# --------------------------------------------------------------------------

def sorted_runs(rng, d_n, cap, counts, key_bits=KEY_BITS):
    """(D, cap) sorted distinct keys per run, KEY_EMPTY padded."""
    from repro_torch.core.params import KEY_EMPTY
    keys = np.full((d_n, cap), KEY_EMPTY, np.int32)
    for d in range(d_n):
        ks = np.unique(rng.integers(0, 2 ** key_bits, counts[d] * 2,
                                    dtype=np.int32))
        ks = rng.permutation(ks)[:counts[d]]
        keys[d, :len(ks)] = np.sort(ks)
        counts[d] = len(ks)
    return keys


def fence_case(name, keys, counts, qs, mu, stride: int = 1):
    """fence_lookup against its plain version over (D, cap) runs with
    their fences every mu keys, searched through every `stride`-th fence
    (an (mu * stride)-wide page, the tuner's stride view; a partial last
    page is pinned inside the run): bitwise equality, device and wall
    times, the plain version's and `torch.searchsorted`'s, and the byte
    bound of the distinct fence and key words the two searches read."""
    import torch
    from repro_torch.kernels import fence_lookup as KFL
    d_n, cap = keys.shape
    q_n = qs.shape[0]
    fences = keys[:, ::mu][:, ::stride].contiguous()
    mu *= stride
    f_n = fences.shape[1]
    got = KFL.fence_lookup_many(qs, fences, keys, counts, mu)
    torch.cuda.synchronize()
    want = KFL.fence_lookup_plain(qs, fences, keys, counts, mu)
    # bytes: queries, counts and outputs once, and each fence and key word
    # once that the two searches of fence_lookup.cu read for this data
    qs_d = qs.expand(d_n, -1).contiguous()
    zero = torch.zeros(qs_d.shape, dtype=torch.int64, device=keys.device)
    f, fence_reads = search_reads(fences, zero, f_n, qs_d, right=True)
    start = ((f - 1).clamp(0, f_n - 1) * mu).clamp(max=cap - mu)
    off, key_reads = search_reads(keys, start, mu, qs_d, right=False)
    idx = start + off.clamp(max=mu - 1)
    hit = ((off < mu) & (keys.gather(1, idx) == qs_d)
           & (idx < counts[:, None]))
    if not torch.equal(torch.where(hit, idx, -1).int(), want):
        raise AssertionError("fence_lookup: the byte count's search "
                             "disagrees with the kernel")
    last = idx + torch.arange(d_n, device=keys.device)[:, None] * cap
    fence_words = int(torch.unique(fence_reads).numel())
    key_words = int(torch.unique(torch.cat([key_reads,
                                            last.reshape(-1)])).numel())
    group, staged = KFL.ops.fence_geometry(f_n)

    def lookup():
        return KFL.fence_lookup_many(qs, fences, keys, counts, mu)

    rec = dict(
        case=name, shape=(f"D={d_n} F={f_n} cap={cap} mu={mu} Q={q_n}"
                          + (f" (stride {stride}, last page partial)"
                             if f_n * mu > cap else "")),
        fences_staged=f"every {group}: {staged} of {f_n}",
        hits=int(hit.sum()),
        bytes_counted=(f"{fence_words} distinct fence words, {key_words} "
                       "distinct key words"),
        max_abs_err=max_abs_err(got, want),
        ms=device_ms(lookup, 50), wall_ms=wall_ms(lookup, 50),
        plain_ms=device_ms(lambda: KFL.fence_lookup_plain(
            qs, fences, keys, counts, mu), 5),
        bound_ms=bound_ms("fence_lookup", q=q_n, runs=d_n,
                          fence_words=fence_words, key_words=key_words),
        library_ms=device_ms(lambda: torch.searchsorted(keys, qs_d), 20))
    log(f"fence_lookup {json.dumps(rec)}")
    if rec["max_abs_err"]:
        raise AssertionError(f"fence_lookup ({name}) differs from its plain "
                             "version")
    return rec


def scan_rows(rng, q_n: int, c_n: int, n_seg: int):
    """Q candidate rows of c_n lanes, each filled to a random width of
    c_n / 4 to c_n lanes in n_seg sorted segments (unique seqs, mixed
    weights), KEY_EMPTY past the fill: (keys, vals, wts, seqs, offsets)
    as numpy int32."""
    from repro_torch.core.params import KEY_EMPTY
    k = np.full((q_n, c_n), KEY_EMPTY, np.int32)
    s = np.zeros((q_n, c_n), np.int32)
    w = np.zeros((q_n, c_n), np.int32)
    off = np.zeros((q_n, n_seg + 1), np.int32)
    for q in range(q_n):
        sizes = rng.multinomial(int(rng.integers(c_n // 4, c_n + 1)),
                                np.ones(n_seg) / n_seg)
        pos = 0
        for i, size in enumerate(sizes):
            k[q, pos:pos + size] = np.sort(rng.choice(
                max(256, 4 * size), size, replace=False))
            pos += size
            off[q, i + 1] = pos
        s[q, :pos] = rng.permutation(c_n * 8)[:pos]
        w[q, :pos] = rng.choice([-1, 1], pos)
    v = rng.integers(-2 ** 31, 2 ** 31 - 1, (q_n, c_n), dtype=np.int32)
    return k, v, w, s, off


def range_case(name, rng, device, q_n, c_n, n_seg):
    """range_merge over Q rows of c_n lanes in n_seg segments, filled to
    a random width: the one-pass kernel and the rounds of the round
    kernel, each against the plain version on all five lanes; device and
    wall times, launches a call, and the byte bound (each filled lane
    read once, every lane written once)."""
    import torch
    from repro_torch.core import runs as RU
    from repro_torch.kernels import range_merge as KRM
    rows = scan_rows(rng, q_n, c_n, n_seg)
    off = rows[-1]
    lanes = [torch.from_numpy(a).to(device) for a in rows]
    counters = (KRM.range_merge, KRM.merge_round)

    def kernel():
        return KRM.range_merge(*lanes, True)

    def rounds():
        return KRM.ops.range_merge_rounds(*lanes, True)

    n0 = [c.launches for c in counters]
    got = kernel()
    n1 = [c.launches for c in counters]
    old = rounds()
    n2 = [c.launches for c in counters]
    torch.cuda.synchronize()
    want = KRM.range_merge_plain(*lanes, True)
    comp = RU.composite(lanes[0], lanes[3])
    filled = int(off[:, -1].sum())
    geo = KRM.ops.range_geometry(c_n, n_seg)
    rec = dict(
        case=name, shape=f"Q={q_n} C={c_n} P={n_seg}",
        tiles=("one a row" if not geo[1] else
               f"<= {geo[3]} a row of <= {geo[0]} lanes (S={geo[1]}, "
               f"G={geo[2]}, samples in shared memory: {geo[4]})"),
        launches_a_call=n1[0] - n0[0],
        merge_round_launches_a_call=n1[1] - n0[1],
        rounds=n2[1] - n1[1],
        bytes_counted=(f"{filled} filled lanes of {q_n * c_n} read, the "
                       "offsets, every lane written"),
        max_abs_err=max_abs_err(got, want),
        rounds_max_abs_err=max_abs_err(old, want),
        ms_by_kernel=device_ms_by_name(kernel, 50),
        wall_ms=wall_ms(kernel, 50),
        rounds_ms=device_ms(rounds, 20), rounds_wall_ms=wall_ms(rounds, 20),
        plain_ms=device_ms(lambda: KRM.range_merge_plain(*lanes, True), 10),
        bound_ms=bound_ms("range_merge", rows=q_n, lanes=c_n,
                          filled=filled, parts=off.shape[1] - 1),
        library_ms=device_ms(lambda: torch.sort(comp, dim=1, stable=True),
                             50))
    rec["ms"] = sum(rec["ms_by_kernel"].values())
    rec["ms_by_kernel"] = {kernel_name(k): v
                           for k, v in rec["ms_by_kernel"].items()}
    log(f"range_merge {json.dumps(rec)}")
    if rec["max_abs_err"] or rec["rounds_max_abs_err"]:
        raise AssertionError(f"range_merge ({name}): the kernel or the "
                             "rounds differ from the plain version")
    if rec["merge_round_launches_a_call"] or rec["launches_a_call"] != (
            1 if not geo[1] else 2):
        raise AssertionError(f"range_merge ({name}): launched "
                             f"{rec['launches_a_call']} kernels and "
                             f"{rec['merge_round_launches_a_call']} rounds")
    return rec


# --------------------------------------------------------------------------
# bloom_probe: one launch a lookup batch, over every disk level
# --------------------------------------------------------------------------

def bloom_stack(keys, p, n: int, eps: float, words: int | None = None):
    """Filters over the runs `keys` (D, cap) sized as the engine sizes an
    n-element run at FP rate eps (`words` physical words, default the
    geometry's): ``(blooms (D, W) int32, k, bits)``."""
    import torch
    from repro_torch.core import bloom as BL
    from repro_torch.core.params import KEY_EMPTY
    bits, w, k = p.bloom_geometry(n, eps)
    words = w if words is None else words
    return (torch.stack([BL.bloom_build(r, r != KEY_EMPTY, words, k, bits)
                         for r in keys]), k, bits)


def bloom_shapes(p, device, rng, keys1, qs1):
    """The bloom_probe shapes, name -> (stacks, keys): the two disk levels
    of a main-phase lookup batch (level 0: D runs of level_cap(0), level
    1: the D runs `keys1` of level_cap(1)), level 1 alone; three levels
    as the adaptive tuner sizes them (k 6, 10 and 13 from
    ADAPTIVE_EPS, words from `bloom_words_physical`, so bits < 32 W;
    level 2's D runs cut to level_cap(2) / ADAPTIVE_DEEP_CUT keys, since
    a filter's bit positions are uint32 and a whole level_cap(2) run
    would need 6.1 Gbit; its words random, half the bits set, with the
    probes of a quarter of the keys planted in run 0); every pair a
    member (level 1's shape, every bit set); one run; Q = 4,093, 1,024
    and 256; levels 0 and 1 at the adaptive phase's WRITE and READ
    allocations, and READ's level 1 alone (level 0 left out). The keys
    are `qs1` (half of them from level 1) with a twentieth of them
    swapped for level-0 keys."""
    import torch
    from repro_torch.core import bloom as BL
    from repro_torch.core.params import TuningPolicy
    q_n = qs1.shape[0]
    cap0 = p.level_cap(0)
    fill0 = np.full(p.D, p.runs_merged * p.Rn, np.int64)
    keys0 = torch.from_numpy(sorted_runs(rng, p.D, cap0, fill0)).to(device)
    qs = qs1.clone()
    n0 = q_n // 20
    qs[:n0] = keys0[torch.from_numpy(rng.integers(0, p.D, n0)).to(device),
                    torch.from_numpy(rng.integers(0, int(fill0.min()), n0))
                    .to(device)]
    lvl0 = bloom_stack(keys0, p, cap0, p.level_eps(0))
    lvl1 = bloom_stack(keys1, p, p.level_cap(1), p.level_eps(1))

    ad = dataclasses.replace(p, tuning=TuningPolicy(mode="adaptive"),
                             eps_per_level=ADAPTIVE_EPS)
    adaptive = []
    for level, keys in ((0, keys0), (1, keys1)):
        n, eps = ad.level_cap(level), ad.level_eps(level)
        adaptive.append(bloom_stack(keys, ad, n, eps,
                                    ad.bloom_words_physical(n, eps)))
    n2, eps2 = ad.level_cap(2) // ADAPTIVE_DEEP_CUT, ad.level_eps(2)
    bits2, _, k2 = ad.bloom_geometry(n2, eps2)
    gen = torch.Generator(device).manual_seed(int(rng.integers(2 ** 31)))
    deep = torch.randint(-2 ** 31, 2 ** 31,
                         (p.D, ad.bloom_words_physical(n2, eps2)),
                         generator=gen, dtype=torch.int32, device=device)
    pos = BL.probe_positions(qs[:q_n // 4], k2, bits2)
    for i in range(k2):
        w = pos[:, i] // 32
        deep[0, w] = BL.words_to_i32(BL.as_u32(deep[0, w])
                                     | (1 << (pos[:, i] % 32)))
    adaptive.append((deep, k2, bits2))
    # the adaptive phase's WRITE and READ allocations (effective bits and
    # k inside words sized at eps_floor), and READ with level 0 left out
    # (the read allocation folds level 0 empty)
    from repro_torch.engine.tuner import build_presets
    tuned = adaptive_params()
    presets = {}
    for name, alloc in build_presets(tuned).items():
        pa = alloc.apply(tuned)
        presets[name] = [
            bloom_stack(keys, pa, pa.level_cap(level), pa.level_eps(level),
                        pa.bloom_words_physical(pa.level_cap(level),
                                                pa.level_eps(level)))
            for level, keys in ((0, keys0), (1, keys1))]
    ones = torch.full_like(lvl1[0], -1)
    return {
        "lookup batch": ([lvl0, lvl1], qs),
        "level 1": ([lvl1], qs),
        "adaptive, 3 levels": (adaptive, qs),
        "WRITE preset, 2 levels": (presets["write"], qs),
        "READ preset, 2 levels": (presets["read"], qs),
        "READ preset, level 0 left out": (presets["read"][1:], qs),
        "every pair a member": ([(ones,) + lvl1[1:]], qs),
        "one run": ([(lvl1[0][:1],) + lvl1[1:]], qs),
        **{f"Q={n}": ([lvl1], qs[:n].contiguous())
           for n in (4093, 1024, 256)},
    }


def bloom_need(stacks, qs):
    """What the early-exit chains of these stacks and keys need: the
    probes they make, and the flat indices (into the stacks' words, level
    after level) of the distinct words they read."""
    import torch
    from repro_torch.core import bloom as BL
    probes, ids, base = 0, [], 0
    for blooms, k, bits in stacks:
        d_n, words = blooms.shape
        pos = BL.probe_positions(qs, k, bits)                  # (Q, k)
        bit = ((blooms[:, pos // 32].long() >> (pos % 32)) & 1).bool()
        n = torch.where(bit.all(-1), k, (~bit).int().argmax(-1) + 1)
        need = torch.arange(k, device=qs.device) < n[..., None]
        word = (torch.arange(d_n, device=qs.device)[:, None, None] * words
                + pos[None] // 32).expand_as(need)
        ids.append(torch.unique(word[need]) + base)
        probes += int(n.sum())
        base += d_n * words
    return probes, torch.cat(ids)


def parent_bloom_levels(lib: Path):
    """The previous bloom_probe (a build of the parent commit's
    `csrc/bloom_probe.cu`, entry `bloom_probe_launch`) behind its
    wrapper's checks, launched as the previous read path launched it:
    once a level."""
    import ctypes

    import torch
    from repro_torch.kernels.bloom_probe import ops
    entry = ctypes.CDLL(str(lib)).bloom_probe_launch
    entry.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 5
                      + [ctypes.c_void_p])
    entry.restype = ctypes.c_int

    def levels(stacks, qs):
        outs = []
        for blooms, k, bits in stacks:
            ops._check(blooms, qs, k, bits)
            out = torch.empty((blooms.shape[0], qs.shape[0]),
                              dtype=torch.bool, device=qs.device)
            if entry(qs.data_ptr(), blooms.data_ptr(), out.data_ptr(),
                     blooms.shape[0], qs.shape[0], blooms.shape[1], k, bits,
                     torch.cuda.current_stream(qs.device).cuda_stream):
                raise RuntimeError("bloom_probe (parent): launch failed")
            outs.append(out)
        return outs
    return levels


def bloom_case(name, stacks, qs, parent):
    """bloom_probe_levels over `stacks` against the plain version of
    each level: launches a call, bitwise equality, device and wall
    times, the plain version's, the byte bound (keys and outputs once,
    each filter word the early-exit chains need once) and one gather of
    exactly those words (a floor of the reads, no library call); with
    `parent`, the previous kernel in turns (parent, kernel, kernel,
    parent): device times, then wall times in three such rounds."""
    import torch
    from repro_torch.kernels import bloom_probe as KBP

    def kernel():
        return KBP.bloom_probe_levels(stacks, qs)

    def plain():
        return [KBP.bloom_probe_plain(b, qs, k, bits) for b, k, bits in stacks]

    n0 = KBP.bloom_probe_levels.launches
    got = kernel()
    n1 = KBP.bloom_probe_levels.launches
    torch.cuda.synchronize()
    want = plain()
    probes, ids = bloom_need(stacks, qs)
    q_n, rows = qs.shape[0], sum(b.shape[0] for b, _, _ in stacks)
    rec = dict(
        case=name,
        shape=" | ".join(f"D={b.shape[0]} W={b.shape[1]} k={k} bits={bits}"
                         for b, k, bits in stacks) + f" | Q={q_n}",
        launches_a_call=n1 - n0, members=sum(int(w.sum()) for w in want),
        bytes_counted=(f"{probes} probes over {ids.numel()} distinct "
                       "filter words"),
        max_abs_err=max_abs_err(tuple(got), tuple(want)),
        ms=device_ms(kernel, 50), wall_ms=wall_ms(kernel, 50),
        plain_ms=device_ms(plain, 10),
        bound_ms=bound_ms("bloom_probe", q=q_n, rows=rows,
                          words=ids.numel()))
    flat = torch.cat([b.reshape(-1) for b, _, _ in stacks])
    rec["gather_floor_ms"] = device_ms(lambda: flat[ids], 50)
    del flat
    if parent is not None:
        old = parent(stacks, qs)
        torch.cuda.synchronize()
        rec["parent_max_abs_err"] = max_abs_err(tuple(old), tuple(want))

        def prev():
            return parent(stacks, qs)
        turns = [prev, kernel, kernel, prev]
        rec.update(turns="parent, kernel, kernel, parent",
                   parent_launches_a_call=len(stacks),
                   turns_ms=[device_ms(f, 50) for f in turns],
                   turns_wall_ms=[[wall_ms(f, 50) for f in turns]
                                  for _ in range(3)])
    log(f"bloom_probe {json.dumps(rec)}")
    if rec["max_abs_err"] or rec.get("parent_max_abs_err"):
        raise AssertionError(f"bloom_probe ({name}): the kernel or the "
                             "parent differs from the plain version")
    if rec["launches_a_call"] != 1:
        raise AssertionError(f"bloom_probe ({name}): "
                             f"{rec['launches_a_call']} launches a call")
    return rec


def bloom_controls(stacks, qs):
    """Planted faults in the two-level launch: in a copy of level 0's
    filters the bit of a member pair's last probe cleared, and in a copy
    of level 1's the bit of a member pair's first probe. The pair must
    then read as a miss, the other level's verdicts must not change,
    and the kernel must still equal the plain version."""
    import torch
    from repro_torch.core import bloom as BL
    from repro_torch.kernels import bloom_probe as KBP
    got = KBP.bloom_probe_levels(stacks, qs)
    out = []
    for level, probe in ((0, "last"), (1, "first")):
        blooms, k, bits = stacks[level]
        d, q = (int(i) for i in got[level].nonzero()[0])
        i = k - 1 if probe == "last" else 0
        pos = int(BL.probe_positions(qs[q:q + 1], k, bits)[0, i])
        cut = blooms.clone()
        word = int(cut[d, pos // 32]) & 0xFFFFFFFF
        cut[d, pos // 32] = int(BL.words_to_i32(torch.tensor(
            word & ~(1 << (pos % 32)))))
        planted = list(stacks)
        planted[level] = (cut, k, bits)
        after = KBP.bloom_probe_levels(planted, qs)
        torch.cuda.synchronize()
        rec = dict(
            level=level, probe=probe, run=d, key=int(qs[q]),
            member_after=bool(after[level][d, q]),
            other_level_unchanged=all(
                torch.equal(after[o], got[o])
                for o in range(len(stacks)) if o != level),
            kernel_equals_plain=all(
                torch.equal(a, KBP.bloom_probe_plain(b, qs, kk, bb))
                for a, (b, kk, bb) in zip(after, planted)))
        log(f"bloom_probe control {json.dumps(rec)}")
        if (rec["member_after"] or not rec["other_level_unchanged"]
                or not rec["kernel_equals_plain"]):
            raise AssertionError(f"bloom_probe control: {rec}")
        out.append(rec)
        del cut, planted, after
    return out


def bloom_phase(p, device, rng, keys1, qs1, parent=None):
    """bloom_probe at every shape of `bloom_shapes`, then the planted
    faults; the record is the lookup batch's (the main path's shape),
    the other shapes under `cases`."""
    import torch
    shapes = bloom_shapes(p, device, rng, keys1, qs1)
    cases = [bloom_case(name, stacks, qs, parent)
             for name, (stacks, qs) in shapes.items()]
    controls = bloom_controls(*shapes["lookup batch"])
    del shapes
    torch.cuda.empty_cache()
    return dict(
        cases[0], name="bloom_probe",
        source="src/repro_torch/csrc/bloom_probe.cu",
        replaces="src/repro/kernels/bloom_probe/bloom_probe.py:30",
        library_ms=None,
        library_note=("no single PyTorch call computes a double-hashed "
                      "Bloom probe; gather_floor_ms is a floor of the "
                      "reads, not a library time"),
        cases=cases[1:], controls=controls)


def level1_data(p, device, rng):
    """Level 1 of the paper geometry on the card: D sorted runs of
    level_cap(1) slots (the second half of them partly filled), their
    counts, and a lookup batch of LOOKUP_BATCH keys, half of them present
    in the runs and half random over twice the key range."""
    import torch
    cap1 = p.level_cap(1)
    counts = np.full(p.D, cap1, np.int64)
    counts[p.D // 2:] = cap1 - cap1 // 7
    keys1 = sorted_runs(rng, p.D, cap1, counts)
    q_n = LOOKUP_BATCH
    present = keys1[rng.integers(0, p.D, q_n // 2),
                    rng.integers(0, cap1 - cap1 // 7, q_n // 2)]
    qs = np.concatenate([present, rng.integers(
        0, 2 ** (KEY_BITS + 1), q_n - q_n // 2, dtype=np.int32)])
    return (torch.from_numpy(keys1).to(device),
            torch.from_numpy(counts.astype(np.int32)).to(device),
            torch.from_numpy(qs.astype(np.int32)).to(device))


def merge_case(shape_name, n_runs: int, cap: int, fill: int, rng,
               device, lanes=None, iters: int | None = None) -> dict:
    """heap_merge over `n_runs` sorted runs of `cap` slots, `fill` keys
    each (the second half of the runs partly filled), or over `lanes`
    (flat keys, wts, seqs of such runs, on the card): the k-way kernel
    (two launches a merge) beside the tournament of round launches it
    replaces, each against the plain version on all four lanes; device
    and wall times (over `iters` calls each, if given), the plain
    version's, a stable sort's, and the bound of the records the merge
    needs (the filled lanes, each read once and written once) beside
    that of all lanes, KEY_EMPTY padding included."""
    import torch
    from repro_torch.core import runs as RU
    from repro_torch.core.params import KEY_EMPTY
    from repro_torch.kernels import heap_merge as KHM

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if lanes is None:
        cnt = np.full(n_runs, fill, np.int64)
        cnt[n_runs // 2:] = fill - fill // 9     # partly filled runs too
        kr = sorted_runs(rng, n_runs, cap, cnt)
        real = kr != KEY_EMPTY
        seqs = np.where(real, rng.permutation(kr.size).reshape(kr.shape), 0)
        wts = np.where(real, rng.choice([-1, 1], kr.shape), 0)
        lanes = [dev(a.reshape(-1).astype(np.int32)) for a in (kr, wts, seqs)]
    n = n_runs * cap
    ix = torch.arange(n, dtype=torch.int32, device=device)

    def kway():
        return KHM.kway_merge(*lanes, ix, n_runs)

    def rounds():
        return KHM.ops.tournament(*lanes, ix, cap, n_runs)

    want = KHM.kway_merge_plain(*lanes, ix, n_runs)
    got = kway()
    old = rounds()
    torch.cuda.synchronize()
    comp = RU.composite(lanes[0], lanes[2])
    filled = int((lanes[0] != KEY_EMPTY).sum())
    rec = dict(
        case=shape_name,
        shape=f"{n_runs} runs x {cap} = {n} lanes",
        filled_lanes=filled,
        samples_in_shared=KHM.ops.kway_geometry(n_runs, cap)[-1],
        max_abs_err=max_abs_err(got, want),
        rounds_max_abs_err=max_abs_err(old, want),
        ms=device_ms(kway, iters or 20), wall_ms=wall_ms(kway, iters or 20),
        # one run takes no round: nothing to time
        rounds_ms=device_ms(rounds, iters or 10) if n_runs > 1 else None,
        rounds_launches=math.ceil(math.log2(n_runs)),
        plain_ms=device_ms(lambda: KHM.kway_merge_plain(*lanes, ix, n_runs),
                           iters or 5),
        bound_ms=bound_ms("heap_merge", lanes=filled),
        bound_all_lanes_ms=bound_ms("heap_merge", lanes=n),
        library_ms=device_ms(lambda: torch.sort(comp, stable=True),
                             iters or 10))
    log(f"heap_merge {json.dumps(rec)}")
    for key, what in (("max_abs_err", "k-way kernel"),
                      ("rounds_max_abs_err", "rounds")):
        if rec[key]:
            raise AssertionError(f"heap_merge {what} ({shape_name}) "
                                 "differs from the plain k-way order")
    del lanes, ix, want, got, old, comp
    torch.cuda.empty_cache()
    return rec


def kernel_phase(p, device, rng, parent_bloom=None):
    """Each kernel against its plain version at main-path shapes;
    `parent_bloom` (see `parent_bloom_levels`) is timed in turns with
    bloom_probe."""
    import torch
    from repro_torch.core.params import KEY_EMPTY

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = []
    q_n = LOOKUP_BATCH
    keys1_t, counts_t, qs_t = level1_data(p, device, rng)

    # -- bloom_probe: one launch over both disk levels of a lookup batch,
    # and the shapes around it (bloom_phase)
    out.append(bloom_phase(p, device, rng, keys1_t, qs_t, parent_bloom))

    # -- fence_lookup: level-1 fences over the same runs (the main path),
    # and a deployment whose level 2 is filled: runs of level_cap(2)
    # whose fences miss shared memory (every G-th fence staged)
    cases = [fence_case("level 1", keys1_t, counts_t, qs_t, p.mu)]
    cap2 = p.level_cap(2)
    gaps = torch.randint(1, 7, (FENCE_DEEP_RUNS, cap2), dtype=torch.int32,
                         device=device)
    keys2 = torch.cumsum(gaps, dim=1, dtype=torch.int32)  # sorted: gaps >= 1
    del gaps
    counts2 = torch.tensor([cap2, cap2 - cap2 // 7] * (FENCE_DEEP_RUNS // 2),
                           dtype=torch.int32, device=device)
    keys2[1::2, cap2 - cap2 // 7:] = KEY_EMPTY
    qs2 = torch.cat([keys2[dev(rng.integers(0, FENCE_DEEP_RUNS, q_n // 2)),
                           dev(rng.integers(0, cap2 - cap2 // 7, q_n // 2))],
                     dev(rng.integers(0, 3 * cap2 + 1, q_n - q_n // 2,
                                      dtype=np.int32))])
    cases.append(fence_case("level 2", keys2, counts2, qs2, p.mu))
    del keys2, counts2, qs2
    torch.cuda.empty_cache()
    # the WRITE preset's stride-2 view at levels 1 and 0 (level 0: 79
    # fences, so the 40th page is partial and pinned to cap - 2 mu)
    cases.append(fence_case("level 1, stride 2", keys1_t, counts_t, qs_t,
                            p.mu, 2))
    cap0 = p.level_cap(0)
    fill0 = np.full(p.D, p.runs_merged * p.Rn, np.int64)
    fill0[p.D // 2:] -= p.Rn // 3
    keys0 = sorted_runs(rng, p.D, cap0, fill0)
    qs0 = np.concatenate([keys0[rng.integers(0, p.D, q_n // 2),
                                rng.integers(0, int(fill0.min()), q_n // 2)],
                          rng.integers(0, 2 ** KEY_BITS, q_n - q_n // 2,
                                       dtype=np.int32)])
    cases.append(fence_case("level 0, stride 2", dev(keys0),
                            dev(fill0.astype(np.int32)),
                            dev(qs0.astype(np.int32)), p.mu, 2))
    out.append(dict(
        cases[0], name="fence_lookup",
        source="src/repro_torch/csrc/fence_lookup.cu",
        replaces="src/repro/kernels/fence_lookup/fence_lookup.py:31",
        cases=cases[1:]))

    # -- heap_merge: where it launches on the main path — the buffer
    # flush (runs_merged memory runs of Rn lanes) and the level-0 ->
    # level-1 spill (D runs of level_cap(0)) — and at the level-1 ->
    # level-2 spill of a deployment that fills level 1 (D runs of
    # level_cap(1), whose samples miss shared memory); the k-way kernel
    # (two launches a merge) beside the tournament of round launches it
    # replaces, each against the plain version on all four lanes
    cases = [merge_case(shape_name, n_runs, cap, fill, rng, device)
             for shape_name, n_runs, cap, fill in (
                 ("spill", p.D, p.level_cap(0), p.runs_merged * p.Rn),
                 ("flush", p.runs_merged_eff, p.Rn, p.Rn),
                 ("deep spill", p.D, p.level_cap(1),
                  p.D * p.runs_merged * p.Rn),
                 # the read allocation: a flush of one memory run, and its
                 # eager level-0 folds of 1 and 2 runs (20 is the spill
                 # above)
                 ("read flush", 1, p.Rn, p.Rn),
                 ("read fold, 1 run", 1, p.level_cap(0),
                  p.runs_merged * p.Rn),
                 ("read fold, 2 runs", 2, p.level_cap(0),
                  p.runs_merged * p.Rn))]
    spill = cases[0]
    out.append(dict(
        spill, name="heap_merge", source="src/repro_torch/csrc/heap_merge.cu",
        replaces="src/repro/kernels/heap_merge/heap_merge.py:48",
        cases=cases[1:]))

    # -- range_merge: Q scans x range_cand lanes of P = 1 + R + 2D parts
    # (the main path: a row is one tile), and the same scans over rows of
    # 16,384 lanes (a larger range_cand; tiles bounded by a split launch):
    # the one-pass kernel beside the rounds of the round kernel it
    # replaces, each against the plain version on all five lanes
    n_seg = 1 + p.R + 2 * p.D
    cases = [range_case(name, rng, device, SCAN_BATCH, c_n, n_seg)
             for name, c_n in (("main", p.range_cand_eff(2)),
                               ("wide", RANGE_WIDE))]
    out.append(dict(
        cases[0], name="range_merge",
        source="src/repro_torch/csrc/range_merge.cu",
        replaces="src/repro/kernels/range_merge/range_merge.py:98",
        cases=cases[1:]))
    for rec in out:
        rec.update(route="cuda", bound_by="bytes",
                   bitwise_equal=rec["max_abs_err"] == 0)
        log(f"kernel {rec['name']:12s} [{rec['shape']}] "
            f"bitwise_equal={rec['bitwise_equal']} "
            f"kernel_ms={rec['ms']:.4f} wall_ms={rec['wall_ms']:.4f} "
            f"plain_ms={rec['plain_ms']:.4f} "
            f"library_ms={rec['library_ms']} bound_ms={rec['bound_ms']:.5f}")
        if rec["max_abs_err"] != 0:
            raise AssertionError(f"{rec['name']}: kernel differs from its "
                                 "plain version")
    return out


# --------------------------------------------------------------------------
# main phase: the paper geometry under a write / read / scan mix
# --------------------------------------------------------------------------

class DenseOracle:
    """numpy equivalent of the dict oracle over keys in [0, 2**bits)."""

    def __init__(self, bits: int):
        self.val = np.zeros(2 ** bits, np.int32)
        self.present = np.zeros(2 ** bits, bool)

    def insert(self, keys, vals):
        uniq, first = np.unique(keys[::-1], return_index=True)  # last wins
        self.val[uniq] = vals[::-1][first]
        self.present[uniq] = True

    def delete(self, keys):
        self.present[keys] = False

    def window(self, lo, hi):
        ks = np.flatnonzero(self.present[lo:hi]) + lo
        return ks.astype(np.int32), self.val[ks]

    def apply(self, keys, vals, wts):
        """A weighted write chunk: the last lane of each key wins, weight
        +1 inserting the pair, -1 deleting the key."""
        uniq, first = np.unique(keys[::-1], return_index=True)
        self.val[uniq] = vals[::-1][first]
        self.present[uniq] = wts[::-1][first] > 0

    def check_lookups(self, qs, vals, found, what: str):
        """Found flags and values of a lookup batch against the oracle."""
        inside = (qs >= 0) & (qs < self.present.size)
        want = np.zeros(qs.size, bool)
        want[inside] = self.present[qs[inside]]
        if not np.array_equal(found, want):
            raise AssertionError(f"{what}: found-flags differ on "
                                 f"{int((found != want).sum())} keys")
        if not np.array_equal(vals[found], self.val[qs[found]]):
            raise AssertionError(f"{what}: values differ from the oracle")


class Clock:
    """Accumulated host time of the `with` blocks, each closed by a
    device synchronize (the engine's answers are host arrays, so the
    device work of a call is done when it returns)."""

    def __init__(self):
        self.total = 0.0

    def __enter__(self):
        import torch
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.total += time.perf_counter() - self._t0


class LaunchTally:
    """The launches of each counted kernel (`counters`, and the round
    kernels of `contract` apart) made inside the `with` blocks: every
    count is set to 0 as a block opens and read as it closes, and the
    blocks' reads are summed."""

    def __init__(self, counters: dict, contract: dict):
        self.fns = {**counters, **contract}
        self.counts = dict.fromkeys(counters, 0)
        self.rounds = dict.fromkeys(contract, 0)

    def __enter__(self):
        for fn in self.fns.values():
            fn.launches = 0
        return self

    def __exit__(self, *exc):
        for out in (self.counts, self.rounds):
            for k in out:
                out[k] += self.fns[k].launches

    def fresh(self) -> "LaunchTally":
        """A tally of the same kernels, every count at 0."""
        return LaunchTally({k: self.fns[k] for k in self.counts},
                           {k: self.fns[k] for k in self.rounds})

    def add(self, other: "LaunchTally") -> None:
        """Add another tally's counts to this one's."""
        for out, more in ((self.counts, other.counts),
                          (self.rounds, other.rounds)):
            for k in out:
                out[k] += more[k]


def wrap_sum(vals) -> int:
    return int(np.int64(vals.astype(np.int64).sum() + 2 ** 31) % 2 ** 32
               - 2 ** 31)


def check_scans(oracle, wins, keys, vals, counts, trunc):
    """Every row a correct sorted prefix; complete when not truncated."""
    for i, (lo, hi) in enumerate(wins):
        ek, ev = oracle.window(int(lo), int(hi))
        c = int(counts[i])
        if not trunc[i] and c != len(ek):
            raise AssertionError(f"scan {lo}:{hi} has {c} keys, expected "
                                 f"{len(ek)}")
        if c > len(ek) or not (np.array_equal(keys[i, :c], ek[:c])
                               and np.array_equal(vals[i, :c], ev[:c])):
            raise AssertionError(f"scan {lo}:{hi} is not a correct prefix")


def check_reads(eng, oracle, rng, pool, n_q: int, n_scan: int) -> dict:
    """`n_q` lookups in batches of LOOKUP_BATCH (half of them `pool` keys,
    half absent), then `n_scan` scans and `n_scan` aggregates of 256-key
    windows in batches of SCAN_BATCH, every answer against `oracle`
    (keys below 2**KEY_BITS). Returns the rates and truncation counts."""
    qs = np.concatenate([pool[rng.integers(0, pool.size, n_q // 2)],
                         rng.integers(2 ** KEY_BITS, 2 ** (KEY_BITS + 1),
                                      n_q - n_q // 2, dtype=np.int32)])
    qs = rng.permutation(qs).astype(np.int32)
    clock = Clock()
    got_v, got_f = [], []
    for i in range(0, n_q, LOOKUP_BATCH):
        with clock:
            v, f = eng.lookup_many(qs[i:i + LOOKUP_BATCH])
        got_v.append(v)
        got_f.append(f)
    t_lookup = clock.total
    got_v, got_f = np.concatenate(got_v), np.concatenate(got_f)
    inside = qs < 2 ** KEY_BITS
    want_f = np.zeros(n_q, bool)
    want_f[inside] = oracle.present[qs[inside]]
    if not np.array_equal(got_f, want_f):
        raise AssertionError(f"lookup found-flags differ on "
                             f"{int((got_f != want_f).sum())} keys")
    if not np.array_equal(got_v[got_f], oracle.val[qs[got_f]]):
        raise AssertionError("lookup values differ from the oracle")

    lo = rng.integers(0, 2 ** KEY_BITS - 256, n_scan, dtype=np.int32)
    wins = np.stack([lo, lo + 256], axis=1)
    clock = Clock()
    n_trunc = 0
    for i in range(0, n_scan, SCAN_BATCH):
        w = wins[i:i + SCAN_BATCH]
        with clock:
            k, v, c, tr = eng.range_many(w)
        check_scans(oracle, w, k, v, c, tr)
        n_trunc += int(tr.sum())
    t_scan = clock.total

    n_agg_trunc = 0
    alo = rng.integers(0, 2 ** KEY_BITS - 256, n_scan, dtype=np.int32)
    awins = np.stack([alo, alo + 256], axis=1)
    clock = Clock()
    for i in range(0, n_scan, SCAN_BATCH):
        w = awins[i:i + SCAN_BATCH]
        with clock:
            c, s, tr = eng.aggregate_many(w)
        for j, (a, b) in enumerate(w):
            if tr[j]:
                n_agg_trunc += 1
                continue
            ek, ev = oracle.window(int(a), int(b))
            if int(c[j]) != len(ek) or int(s[j]) != wrap_sum(ev):
                raise AssertionError(f"aggregate {a}:{b} differs")
    t_agg = clock.total
    return dict(lookups=n_q, lookup_ops_per_s=n_q / t_lookup,
                scans=n_scan, scans_per_s=n_scan / t_scan,
                scans_truncated=n_trunc, aggregates=n_scan,
                aggregates_per_s=n_scan / t_agg,
                aggregates_truncated=n_agg_trunc)


def main_phase(device, seed: int, n_writes: int):
    import torch
    from repro_torch.configs.slsm_paper import paper_params
    from repro_torch.engine import SLSM

    p = paper_params(merge_budget=1, range_cand=512)
    rng = np.random.default_rng(seed + 1)
    eng = SLSM(p, device=device)
    oracle = DenseOracle(KEY_BITS)
    rounds = 80
    per = n_writes // rounds
    n_del = per // 10
    written = []
    n_ops = 0
    clock = Clock()
    for r in range(rounds):
        ks = rng.integers(0, 2 ** KEY_BITS, per, dtype=np.int32)
        vs = rng.integers(-2 ** 31, 2 ** 31 - 1, per, dtype=np.int32)
        written.append(ks)
        pool = np.concatenate(written)
        dels = pool[rng.integers(0, pool.size, n_del)]
        with clock:
            eng.insert(ks, vs)
            eng.delete(dels)
        oracle.insert(ks, vs)
        oracle.delete(dels)
        n_ops += per + n_del
    t_write = clock.total
    pool = np.concatenate(written)

    # reads scale with the write volume (2**20 lookups and 2048 scans at
    # the default 8M writes) so a rehearsal with fewer writes stays short
    scale = n_writes / 8_000_000
    n_q = max(LOOKUP_BATCH, round(scale * 256) * LOOKUP_BATCH)
    n_scan = max(SCAN_BATCH, round(scale * 64) * SCAN_BATCH)
    reads = check_reads(eng, oracle, rng, pool, n_q, n_scan)
    if eng.n_levels != 2:
        raise AssertionError(f"expected 2 disk levels, got {eng.n_levels}")
    return eng, dict(
        write_ops=n_ops, write_s=t_write, insert_ops_per_s=n_ops / t_write,
        **reads, live_keys=int(oracle.present.sum()), n_levels=eng.n_levels,
        resident_records=eng.n_live,
        stats={k: int(v) for k, v in eng.stats.items()})


class merge_tally:
    """Within the block, tally every k-way merge the engine runs by its
    shape (runs x lanes) and the heap_merge launches it made: the flushes
    and the spills of the main path."""

    def __init__(self, into: dict, counter):
        from repro_torch.engine import backend
        self.backend, self.into, self.counter = backend, into, counter

    def __enter__(self):
        real = self.real = self.backend.merge_runs

        def merge_runs(keys2d, *rest):
            n0 = self.counter.launches
            out = real(keys2d, *rest)
            rec = self.into.setdefault("x".join(map(str, keys2d.shape)),
                                       dict(merges=0, launches=0))
            rec["merges"] += 1
            rec["launches"] += self.counter.launches - n0
            return out

        self.backend.merge_runs = merge_runs

    def __exit__(self, *exc):
        self.backend.merge_runs = self.real


def flow_busy(fn):
    """A flow's window fn() run once unprofiled (host wall time) and once
    under torch.profiler (device time of every kernel it saw): the
    record with the device-busy share (device time over the unprofiled
    wall time), and the device time by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    clock = Clock()
    with clock:
        fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = device_us_by_name(prof)
    busy_ms = sum(by_name.values()) / 1e3
    return dict(wall_ms=clock.total * 1e3, device_ms=busy_ms,
                device_busy_share=(busy_ms / (clock.total * 1e3) if busy_ms
                                   else "not measured")), by_name


def profile_phase(eng, seed: int):
    """Where the time goes, per flow of the main path (`flow_busy`), with
    the six largest device items."""
    rng = np.random.default_rng(seed + 3)
    ks = rng.integers(0, 2 ** KEY_BITS, 40 * eng.p.Rn, dtype=np.int32)
    vs = rng.integers(-2 ** 31, 2 ** 31 - 1, ks.size, dtype=np.int32)
    qs = rng.integers(0, 2 ** (KEY_BITS + 1), 8 * LOOKUP_BATCH,
                      dtype=np.int32)
    lo = rng.integers(0, 2 ** KEY_BITS - 256, 4 * SCAN_BATCH, dtype=np.int32)
    wins = np.stack([lo, lo + 256], axis=1)
    flows = {
        "write": lambda: eng.insert(ks, vs),
        "lookup": lambda: [eng.lookup_many(qs[i:i + LOOKUP_BATCH])
                           for i in range(0, qs.size, LOOKUP_BATCH)],
        "scan": lambda: [eng.range_many(wins[i:i + SCAN_BATCH])
                         for i in range(0, len(wins), SCAN_BATCH)],
        "aggregate": lambda: [eng.aggregate_many(wins[i:i + SCAN_BATCH])
                              for i in range(0, len(wins), SCAN_BATCH)],
    }
    out = {}
    for name, fn in flows.items():
        out[name], by_name = flow_busy(fn)
        out[name]["top"] = [(k[:48], round(us / 1e3, 4))
                            for k, us in by_name.most_common(6)]
    return out


def cascade_phase(device, seed: int):
    """Scaled geometry through deepest-level compactions."""
    from repro_torch.core.oracle import DictOracle
    from repro_torch.engine import SLSM

    p = cascade_params()
    assert [p.level_cap(i) for i in range(3)] == [2048, 8192, 131072]
    rng = np.random.default_rng(seed + 2)
    eng, oracle = SLSM(p, device=device), DictOracle()
    for _ in range(100):
        ks = rng.integers(0, 2 ** 16, 3000, dtype=np.int32)
        vs = rng.integers(-2 ** 31, 2 ** 31 - 1, 3000, dtype=np.int32)
        eng.insert(ks, vs)
        oracle.insert(ks, vs)
        dels = rng.integers(0, 2 ** 16, 1000, dtype=np.int32)
        eng.delete(dels)
        oracle.delete(dels)
    qs = np.arange(-8, 2 ** 16 + 8, dtype=np.int32)
    v, f = eng.lookup_many(qs)
    vo, fo = oracle.lookup(qs)
    if not (np.array_equal(f, fo) and np.array_equal(v[f], vo[fo])):
        raise AssertionError("cascade lookups differ from the oracle")
    lo = rng.integers(0, 2 ** 16, 64, dtype=np.int32)
    wins = np.stack([lo, lo + rng.integers(1, 400, 64, dtype=np.int32)], 1)
    k, vv, c, tr = eng.range_many(wins)
    for i, (a, b) in enumerate(wins):
        ek, ev = oracle.range(int(a), int(b))
        ci = int(c[i])
        if (not tr[i] and ci != len(ek)) or ci > len(ek) or not (
                np.array_equal(k[i, :ci], ek[:ci])
                and np.array_equal(vv[i, :ci], ev[:ci])):
            raise AssertionError(f"cascade scan {a}:{b} differs")
    c, s, tr = eng.aggregate_many(wins)
    for i, (a, b) in enumerate(wins):
        if not tr[i] and (int(c[i]), int(s[i])) != oracle.aggregate(
                int(a), int(b)):
            raise AssertionError(f"cascade aggregate {a}:{b} differs")
    if eng.stats["compactions"] < 1 or eng.stats["rows_annihilated"] <= 0:
        raise AssertionError(f"no annihilating compaction: {eng.stats}")
    return dict(compactions=eng.stats["compactions"],
                rows_annihilated=eng.stats["rows_annihilated"],
                spills=eng.stats["spills"], n_levels=eng.n_levels,
                live_keys=len(oracle.d))


# --------------------------------------------------------------------------
# adaptive phase: the tuner through a write-heavy -> read-heavy shift
# --------------------------------------------------------------------------

def adaptive_params():
    """The paper's Table 1 geometry with the reference's canonical
    shifting policy (`repro.bench.scenarios.ADAPTIVE`) and max_levels 4:
    the read allocation's eager level-0 fold turns every sealed memory
    run into a level-1 run, so level 1 spills into level 2, whose runs
    at max_levels 3 (the deepest, D times wider) would take ~115 GB."""
    from repro_torch.configs.slsm_paper import paper_params
    from repro_torch.core.params import TuningPolicy
    return paper_params(merge_budget=1, range_cand=512, max_levels=4,
                        tuning=TuningPolicy(mode="adaptive", interval=512,
                                            eps_floor=1e-4))


class probe_tally:
    """Within the block, while `active`, record the disk levels of every
    `bloom_probe_levels` call the engine makes (matched by their filter
    tensors)."""

    def __init__(self, eng):
        from repro_torch.engine import backend
        self.backend, self.eng = backend, eng
        self.calls, self.active = [], False

    def __enter__(self):
        real = self.real = self.backend.bloom_probe_levels

        def bloom_probe_levels(stacks, qs):
            if not self.active:
                return real(stacks, qs)
            levels = self.eng.state.levels
            self.calls.append(tuple(
                i for i, lv in enumerate(levels)
                if any(b is lv.blooms for b, _, _ in stacks)))
            return real(stacks, qs)

        self.backend.bloom_probe_levels = bloom_probe_levels
        return self

    def __exit__(self, *exc):
        self.backend.bloom_probe_levels = self.real


def adaptive_phase(device, seed: int, n: int, tally, p=None):
    """The adaptive engine through the shifting stream: writes in stream
    order between lookup batches of LOOKUP_BATCH (every other one
    sparse), each batch checked against the numpy oracle; scans at the
    end. The kernels' launches are counted in `tally` from after
    `warm()` to the end of the traffic. Returns the engine, its oracle,
    the record and the phase-1 keys."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import SLSM
    from repro_torch.engine.read_path import host_occupancy
    from repro_torch.engine.tuner import retune_filters

    from repro_torch.bench.workloads import make_shifting

    p = p or adaptive_params()
    w = make_shifting(n, seed, n_ranges=32, span=65_536)
    n1, nl1 = w.meta["n_phase1"], w.meta["n_lookups_phase1"]
    k1, v1, k2, v2 = w.keys[:n1], w.vals[:n1], w.keys[n1:], w.vals[n1:]
    l1, l2, wins = w.lookups[:nl1], w.lookups[nl1:], w.ranges
    eng, oracle = SLSM(p, device=device), DenseOracle(KEY_BITS)
    alloc_time = collections.defaultdict(float)
    alloc_lookups = collections.Counter()
    retunes = []
    real_retune = eng.apply_retune

    def timed_retune():
        # the switch on the host clock; then the card's time of the same
        # rebuild, profiled apart (at the active allocation a rebuild is
        # a bitwise no-op, and it launches none of the counted kernels)
        clock, levels = Clock(), eng.n_levels
        with clock:
            real_retune()
        with profiled, profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
            retune_filters(eng.p_active, eng.state)
        retunes.append(dict(
            to=eng.tuner.active, levels=levels, wall_ms=clock.total * 1e3,
            device_ms=sum(device_us_by_name(prof).values()) / 1e3))

    eng.apply_retune = timed_retune
    eng.warm()          # builds the kernels, runs each read op per preset
    seen, probes = set(), []
    n_batches = [0, 0]
    write_clock, profiled = Clock(), Clock()   # the latter inside the former

    def phase(keys, vals, lookups):
        batches = max(1, -(-lookups.size // LOOKUP_BATCH))
        cut = np.linspace(0, keys.size, batches + 1).astype(np.int64)
        for b in range(batches):
            ks, vs = keys[cut[b]:cut[b + 1]], vals[cut[b]:cut[b + 1]]
            with write_clock:
                eng.insert(ks, vs)
            oracle.insert(ks, vs)
            seen.add(eng.tuner.active)
            qs = lookups[b * LOOKUP_BATCH:(b + 1) * LOOKUP_BATCH]
            if not qs.size:
                continue
            sparse = bool(sum(n_batches) % 2)
            alloc = eng.tuner.active
            clock, made = Clock(), len(levels_probed.calls)
            levels_probed.active = True
            with clock:
                vals_q, found = eng.lookup_many(qs, sparse=sparse)
            levels_probed.active = False
            # each batch's one probe call against the levels holding a run
            probes.append((levels_probed.calls[made:], tuple(
                i for i, r in enumerate(host_occupancy(eng.state)[1]) if r)))
            way = f"{alloc} {'sparse' if sparse else 'dense'}"
            alloc_time[way] += clock.total
            alloc_lookups[way] += qs.size
            oracle.check_lookups(qs, vals_q, found,
                                 f"adaptive {'sparse' if sparse else 'dense'}"
                                 f" lookups ({alloc})")
            n_batches[sparse] += 1
            seen.add(eng.tuner.active)

    with tally, probe_tally(eng) as levels_probed:
        phase(k1, v1, l1)
        reached_write = "write" in seen
        phase(k2, v2, l2)
        eng.apply_retune = real_retune
        n_trunc = 0
        for i in range(0, len(wins), SCAN_BATCH):
            w = wins[i:i + SCAN_BATCH]
            k, v, c, tr = eng.range_many(w)
            check_scans(oracle, w, k, v, c, tr)
            n_trunc += int(tr.sum())
        qs = l2[-LOOKUP_BATCH:]
        dense, sparse = eng.lookup_many(qs), eng.lookup_many(qs, sparse=True)
    both_ways = all(np.array_equal(a, b) for a, b in zip(dense, sparse))
    occ = host_occupancy(eng.state)
    left_out = sum(1 for calls, occupied in probes
                   if calls == [occupied] and 0 not in occupied)
    wrong = [c for c in probes if c[0] != [c[1]]]
    rec = dict(
        params=dict(R=p.R, Rn=p.Rn, D=p.D, mu=p.mu, eps=p.eps,
                    max_levels=p.max_levels, merge_budget=p.merge_budget,
                    range_cand=p.range_cand, interval=p.tuning.interval,
                    eps_floor=p.tuning.eps_floor),
        writes=int(k1.size + k2.size), lookups=int(l1.size + l2.size),
        dense_batches=n_batches[0], sparse_batches=n_batches[1],
        scans=len(wins), scans_truncated=n_trunc,
        insert_ops_per_s=(k1.size + k2.size) / (write_clock.total
                                                - profiled.total),
        lookups_per_s_by_allocation_and_search={
            a: alloc_lookups[a] / alloc_time[a] for a in alloc_lookups},
        retunes=retunes, allocations_seen=sorted(seen),
        reached_write_in_phase_1=reached_write, active_at_end=eng.tuner.active,
        read_frac=eng.tuner.read_frac, probe_samples=eng.tuner._n_samples,
        level_candidates=eng.tuner.level_candidates.tolist(),
        level_hits=eng.tuner.level_hits.tolist(),
        run_count=occ[0], level_runs=list(occ[1]),
        probe_launch_levels={"+".join(map(str, k)) or "none": v
                             for k, v in collections.Counter(
                                 levels_probed.calls).items()},
        lookups_with_level_0_left_out=left_out,
        dense_equals_sparse_at_end=both_ways,
        stats={k: int(v) for k, v in eng.stats.items()})
    log("adaptive " + json.dumps(rec))
    if not (both_ways and reached_write and eng.tuner.active == "read"
            and eng.stats["retunes"] >= 2 and eng.tuner._n_samples >= 1
            and occ[1][0] == 0 and left_out and not wrong):
        raise AssertionError(f"adaptive phase: {rec}; probes whose levels "
                             f"differ from the occupied ones: {wrong[:4]}")
    # the device half of a RETUNE at this state: every resident filter
    # rebuilt at the active allocation (what a switch rebuilds)
    rec["retune_rebuild"] = dict(
        levels=eng.n_levels,
        device_ms=device_ms(lambda: retune_filters(eng.p_active, eng.state),
                            2, warmup=1),
        wall_ms=wall_ms(lambda: retune_filters(eng.p_active, eng.state), 2,
                        warmup=0))
    torch.cuda.empty_cache()
    return eng, oracle, rec, k1


def adaptive_profile(eng, seed: int):
    """Device-busy share of each adaptive flow at the phase's end
    (`flow_busy`): dense and sparse lookups, scans, and a write trickle,
    whose pairs are returned for the oracle."""
    rng = np.random.default_rng(seed + 5)
    qs = rng.integers(0, 2 ** KEY_BITS, 4 * LOOKUP_BATCH, dtype=np.int32)
    ks = rng.integers(0, 2 ** (KEY_BITS - 1), 2 * eng.p.Rn,
                      dtype=np.int32) * 2
    lo = rng.integers(0, 2 ** KEY_BITS - 256, 2 * SCAN_BATCH, dtype=np.int32)
    wins = np.stack([lo, lo + 256], axis=1)
    flows = {
        "lookup dense": lambda: [eng.lookup_many(qs[i:i + LOOKUP_BATCH])
                                 for i in range(0, qs.size, LOOKUP_BATCH)],
        "lookup sparse": lambda: [
            eng.lookup_many(qs[i:i + LOOKUP_BATCH], sparse=True)
            for i in range(0, qs.size, LOOKUP_BATCH)],
        "scan": lambda: [eng.range_many(wins[i:i + SCAN_BATCH])
                         for i in range(0, len(wins), SCAN_BATCH)],
        "write trickle": lambda: eng.insert(ks, ks),
    }
    return {name: flow_busy(fn)[0] for name, fn in flows.items()}, (ks, ks)


# --------------------------------------------------------------------------
# tape phase: coalesced mixed-op windows through run_tape
# --------------------------------------------------------------------------

TAPE_WINDOWS = 512
# keys a write chunk carries on the adaptive engine: every sealed run
# becomes its own level-1 run under the read allocation, and level 2
# fills after 400 of them, so its writes are cut from 1-800 to 1-16
TAPE_WRITE_MAX = 16
SCALED_KEYS = 2 ** 16   # the scaled tape's even keys (its deepest level
                        # holds 131,072)
SCALED_WINDOWS = 256    # ~0.4 s each on an H100, two or more compactions


def tape_windows(rng, n_windows: int, pool: np.ndarray, write_max: int,
                 fresh: bool = True):
    """Windows of 4-64 chunks: writes half of them (1-`write_max` even
    keys, fresh or, without `fresh`, from `pool`; a tenth deletes of
    `pool` keys at weight -1, at the chunk's tail, so that the ops one
    by one replay a chunk as one insert and one delete), lookups two
    fifths (1-800 `pool` keys, a quarter absent), ranges a tenth (1-4
    windows of 256 keys)."""
    from repro_torch.engine.tape import TapeChunk
    out = []
    for _ in range(n_windows):
        chunks = []
        for _ in range(int(rng.integers(4, 65))):
            u = rng.random()
            if u < 0.5:
                m = int(rng.integers(1, write_max + 1))
                ks = ((rng.integers(0, 2 ** (KEY_BITS - 1), m) * 2).astype(
                    np.int32) if fresh else rng.choice(pool, m))
                dele = np.arange(m) >= m - rng.binomial(m, 0.1)
                ks[dele] = rng.choice(pool, int(dele.sum()))
                vs = np.where(dele, 0, rng.integers(-2 ** 31, 2 ** 31 - 1, m,
                                                    dtype=np.int64))
                chunks.append(TapeChunk("write", ks, vs.astype(np.int32),
                                        np.where(dele, -1, 1).astype(
                                            np.int32)))
            elif u < 0.9:
                m = int(rng.integers(1, 801))
                qs = rng.choice(pool, m)
                qs[: m // 4] |= 1
                chunks.append(TapeChunk("lookup", qs.astype(np.int32),
                                        np.zeros(m, np.int32)))
            else:
                m = int(rng.integers(1, 5))
                lo = rng.choice(pool, m).astype(np.int32)
                chunks.append(TapeChunk("range", lo, lo + 256))
        out.append(chunks)
    return out


def split_chunks(chunks, p):
    """The same op stream in chunks of at most `chunk_capacity(p, kind)`
    (a geometry with smaller runs takes more, smaller chunks)."""
    from repro_torch.engine.tape import TapeChunk, chunk_capacity
    out = []
    for ch in chunks:
        cap = chunk_capacity(p, ch.kind)
        for i in range(0, len(ch.keys), cap):
            out.append(TapeChunk(ch.kind, ch.keys[i:i + cap],
                                 ch.vals[i:i + cap],
                                 None if ch.wts is None
                                 else ch.wts[i:i + cap]))
    return out


def check_tape(oracle, chunks, results, what: str):
    """Replay a tape's writes into the oracle in stream order; every
    lookup and scan against it."""
    for ch, res in zip(chunks, results):
        if ch.kind == "write":
            oracle.apply(ch.keys, ch.vals, ch.wts)
        elif ch.kind == "lookup":
            oracle.check_lookups(ch.keys, res[0], res[1], what)
        else:
            check_scans(oracle, np.stack([ch.keys, ch.vals], 1), *res)


def op_by_op(eng, chunks):
    """The chunks as the engine's own calls, one by one: writes as
    insert/delete runs in lane order, lookups `lookup_many`, ranges
    `range_many`. Returns the results in `run_tape`'s form."""
    out = []
    for ch in chunks:
        if ch.kind == "write":
            edges = np.flatnonzero(np.diff(ch.wts)) + 1
            for ks, vs, ws in zip(*(np.split(a, edges)
                                    for a in (ch.keys, ch.vals, ch.wts))):
                if ws[0] > 0:
                    eng.insert(ks, vs)
                else:
                    eng.delete(ks)
            out.append(None)
        elif ch.kind == "lookup":
            out.append(eng.lookup_many(ch.keys))
        else:
            out.append(eng.range_many(np.stack([ch.keys, ch.vals], 1)))
    return out


def count_syncs(fn):
    """fn() with PyTorch's CUDA sync debug mode on: the result and the
    blocking reads it made (synchronizing operations), by call site."""
    import collections
    import warnings

    import torch
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))


class segment_tally:
    """Within the blocks, the tape segments (`tape.exec_tape` calls) each
    engine runs, by engine."""

    def __init__(self):
        import collections
        self.by_engine = collections.Counter()

    def __enter__(self):
        from repro_torch.engine import tape as TP
        self.TP, self.real = TP, TP.exec_tape

        def exec_tape(eng, *args):
            self.by_engine[id(eng)] += 1
            return self.real(eng, *args)

        TP.exec_tape = exec_tape
        return self

    def __exit__(self, *exc):
        self.TP.exec_tape = self.real


def tape_phase(seed: int, eng, oracle, pool, n_windows: int, tally):
    """`n_windows` windows through `run_tape` on the adaptive engine as
    it ends (read allocation; writes of 1-TAPE_WRITE_MAX keys), every
    result against the oracle, one `voluntary_steps(1)` between windows,
    whose launches `tally` counts."""
    import collections

    from repro_torch.engine.read_path import host_occupancy
    rng = np.random.default_rng(seed + 7)
    windows = [split_chunks(w, eng.p)
               for w in tape_windows(rng, n_windows, pool, TAPE_WRITE_MAX)]
    clock, syncs = Clock(), collections.Counter()
    segments = segment_tally()
    with segments:
        for i, chunks in enumerate(windows):
            with clock, tally:
                res, sites = count_syncs(
                    lambda: eng.run_tape(chunks, bool(i % 2)))
                eng.voluntary_steps(1)
            syncs.update(sites)
            check_tape(oracle, chunks, res, f"tape window {i}")
    rec = dict(windows=n_windows, **tape_mix(windows),
               active=eng.tuner.active,
               segments=segments.by_engine[id(eng)],
               window_ms=clock.total * 1e3 / n_windows,
               blocking_reads_a_window=sum(syncs.values()) / n_windows,
               blocking_reads_by_site=dict(syncs.most_common(8)),
               level_runs=list(host_occupancy(eng.state)[1]),
               stats={k: int(v) for k, v in eng.stats.items()})
    log("tape " + json.dumps(rec))
    return rec


def tape_scaled_phase(device, seed: int, n_windows: int, tally):
    """`n_windows` windows with the issue's 1-800-key writes (over
    SCALED_KEYS keys) through `run_tape` and op by op on two engines at
    the cascade's scaled geometry, `voluntary_steps(1)` between windows:
    answers equal and exact against the oracle, >= 1 compaction. `tally`
    counts the `run_tape` engine's launches (not the op-by-op one's)."""
    import collections

    from repro_torch.core.params import SLSMParams
    from repro_torch.engine import SLSM
    rng = np.random.default_rng(seed + 8)
    p = SLSMParams(R=8, Rn=256, eps=1e-3, D=4, m=1.0, mu=64, max_levels=3,
                   merge_budget=1, range_cand=512)
    keys = np.arange(0, 2 * SCALED_KEYS, 2, dtype=np.int32)
    windows = [split_chunks(w, p)
               for w in tape_windows(rng, n_windows, keys, 800, fresh=False)]
    tape, ops = SLSM(p, device=device), SLSM(p, device=device)
    scaled_oracle = DenseOracle(KEY_BITS)
    t_clock, o_clock, t_syncs = Clock(), Clock(), collections.Counter()
    segments = segment_tally()
    for i, chunks in enumerate(windows):
        with t_clock, tally, segments:
            got, sites = count_syncs(lambda: tape.run_tape(chunks))
            tape.voluntary_steps(1)
        t_syncs.update(sites)
        with o_clock:
            want = op_by_op(ops, chunks)
            ops.voluntary_steps(1)
        for ch, g, w in zip(chunks, got, want):
            if w is not None and not all(np.array_equal(a, b)
                                         for a, b in zip(g, w)):
                raise AssertionError(f"tape window {i}: run_tape and the "
                                     f"ops one by one differ ({ch.kind})")
        check_tape(scaled_oracle, chunks, got, f"scaled tape window {i}")
    rec = dict(
        windows=n_windows,
        params=dict(R=p.R, Rn=p.Rn, D=p.D, mu=p.mu, max_levels=p.max_levels),
        **tape_mix(windows), segments=segments.by_engine[id(tape)],
        tape_window_ms=t_clock.total * 1e3 / n_windows,
        op_by_op_window_ms=o_clock.total * 1e3 / n_windows,
        blocking_reads_a_window=sum(t_syncs.values()) / n_windows,
        blocking_reads_by_site=dict(t_syncs.most_common(8)),
        seals=tape.stats["seals"], flushes=tape.stats["flushes"],
        spills=tape.stats["spills"], compactions=tape.stats["compactions"],
        n_levels=tape.n_levels)
    if tape.stats["compactions"] < 1:
        raise AssertionError(f"scaled tape: no compaction {rec}")
    log("tape scaled " + json.dumps(rec))
    return rec


def tape_mix(windows) -> dict:
    """Chunks by kind and write keys of a list of windows."""
    import collections
    return dict(chunks=dict(collections.Counter(
        ch.kind for w in windows for ch in w)),
        write_keys=sum(len(ch.keys) for w in windows for ch in w
                       if ch.kind == "write"))


# --------------------------------------------------------------------------
# durable phase: the WAL, a snapshot, a torn tail and restore on the card
# --------------------------------------------------------------------------

DURABLE_INSERTS = 2_000_000     # in calls of DURABLE_CALL keys; a delete
DURABLE_CALL = 800              # call of as many keys after every tenth
WRITER_CALLS = 600              # the killed writer's stream, far past the kill
WRITER_KILL_AFTER = (24, 49)    # acknowledged calls before the SIGKILL
WRITER_LOOKUPS = 4096           # keys a lookup call of the killed writer


def fs_type(path) -> str:
    """Filesystem type of the mount that holds `path` (the longest mount
    point over it in /proc/self/mounts)."""
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    with open("/proc/self/mounts") as f:
        for line in f:
            mnt, typ = line.split()[1:3]
            mnt = mnt.replace("\\040", " ")
            inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best):
                best, kind = mnt, typ
    return kind


class fsync_clock:
    """The time and count of every `os.fsync` inside the blocks."""

    def __init__(self):
        self.total, self.count = 0.0, 0

    def __enter__(self):
        self.real = os.fsync

        def timed(fd):
            t0 = time.perf_counter()
            self.real(fd)
            self.total += time.perf_counter() - t0
            self.count += 1

        os.fsync = timed

    def __exit__(self, *exc):
        os.fsync = self.real


def durable_calls(rng, n_inserts: int, size: int):
    """Insert calls of `size` uniform keys and, after every tenth, a
    delete call of `size` keys drawn from all written so far (the main
    phase's mix): ("insert", keys, vals) / ("delete", keys, None)."""
    written = np.empty(n_inserts // size * size, np.int32)
    for i in range(n_inserts // size):
        ks = rng.integers(0, 2 ** KEY_BITS, size, dtype=np.int32)
        written[i * size:(i + 1) * size] = ks
        yield "insert", ks, rng.integers(-2 ** 31, 2 ** 31 - 1, size,
                                         dtype=np.int32)
        if i % 10 == 9:
            n = (i + 1) * size
            yield "delete", written[rng.integers(0, n, size)], None


def durable_phase(device, seed: int, n_inserts: int, tally, p=None):
    """The main phase's geometry with a WAL fsynced at every call: each
    call to a volatile engine, then to the durable one (both on the
    card), a snapshot after the first half of the writes, a torn tail
    in the last record, and `SLSM.restore` on the card, whose answers
    are held against the oracle of the durable prefix. `tally` counts
    from just before the restore to after its reads."""
    import shutil

    import torch
    from repro_torch.configs.slsm_paper import paper_params
    from repro_torch.engine import SLSM
    from repro_torch.engine import wal as WAL

    t_phase = time.perf_counter()
    p = p or paper_params(merge_budget=1, range_cand=512)
    root = ROOT / "build" / "durable"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rec = dict(directory=str(root.relative_to(ROOT)), fs_type=fs_type(root))
    log(f"durable: WAL directory {rec['directory']} on {rec['fs_type']}")
    rng = np.random.default_rng(seed + 11)
    calls = list(durable_calls(rng, n_inserts, DURABLE_CALL))
    vol = SLSM(p, device=device)
    dur = SLSM(p, device=device,
               durability=WAL.Durability(root / "wal", fsync=True))
    oracle = DenseOracle(KEY_BITS)
    v_clock, d_clock, fsyncs = Clock(), Clock(), fsync_clock()
    n_ops, snap = 0, None
    for i, (kind, ks, vs) in enumerate(calls):
        for eng, clock in ((vol, v_clock), (dur, d_clock)):
            with clock, fsyncs:
                if kind == "insert":
                    eng.insert(ks, vs)
                else:
                    eng.delete(ks)
        n_ops += ks.size
        if i < len(calls) - 1:          # the last call's record is torn
            (oracle.insert(ks, vs) if kind == "insert"
             else oracle.delete(ks))
        if snap is None and n_ops >= n_inserts // 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            snap = dur.snapshot()
            rec.update(snapshot_ms=(time.perf_counter() - t0) * 1e3,
                       snapshot_bytes=sum(f.stat().st_size
                                          for f in snap.iterdir()),
                       snapshot_at_ops=n_ops)
    wal_stats = dur.durability.stats()
    rec.update(
        calls=len(calls), write_ops=n_ops,
        volatile_write_ops_per_s=n_ops / v_clock.total,
        durable_write_ops_per_s=n_ops / d_clock.total,
        volatile_ms_a_call=v_clock.total * 1e3 / len(calls),
        durable_ms_a_call=d_clock.total * 1e3 / len(calls),
        wal_bytes=wal_stats["wal_bytes"], wal_syncs=wal_stats["wal_syncs"],
        wal_bytes_an_op=wal_stats["wal_bytes"] / n_ops,
        fsyncs=fsyncs.count, fsync_ms_a_sync=fsyncs.total * 1e3 / fsyncs.count)
    pool = np.flatnonzero(oracle.present).astype(np.int32)
    del dur, vol, eng                   # the crash: no close()
    torch.cuda.empty_cache()

    wal_path = root / "wal" / "wal.log"
    offsets = WAL.record_offsets(wal_path)
    last, start, end = offsets[-1]
    if last.kind not in WAL.WRITE_KINDS:
        raise AssertionError(f"the WAL ends in a record of kind {last.kind}")
    cut = start + int(rng.integers(1, end - start))
    with open(wal_path, "r+b") as f:
        f.truncate(cut)
    watermark = WAL.list_snapshots(root / "wal")[-1][0]
    tail = [r for r, _, _ in offsets[:-1] if r.seqno > watermark]
    tail_ops = sum(WAL.decode_write(r.payload, r.kind)[0].size for r in tail)

    with tally:
        t0 = time.perf_counter()
        eng = SLSM.restore(root / "wal", device=device)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        reads = check_reads(eng, oracle, rng, pool, 256 * LOOKUP_BATCH,
                            64 * SCAN_BATCH)
    if eng.stats["replayed_records"] != len(tail):
        raise AssertionError(f"restore replayed "
                             f"{eng.stats['replayed_records']} records, the "
                             f"durable tail holds {len(tail)}")
    rec.update(
        torn_record=dict(seqno=last.seqno, cut=cut, start=start, end=end),
        snapshot_seqno=watermark, restore_us=eng.stats["restore_us"],
        restore_wall_ms=restore_s * 1e3,
        replayed_records=eng.stats["replayed_records"],
        replayed_write_ops=tail_ops,
        replay_write_ops_per_s=tail_ops / restore_s, n_levels=eng.n_levels,
        **{f"after_restore_{k}": v for k, v in reads.items()},
        phase_s=time.perf_counter() - t_phase)
    return rec


def writer_params():
    """The cascade's scaled geometry with the reference's shifting
    policy, so that RETUNE records reach the WAL."""
    from repro_torch.core.params import SLSMParams, TuningPolicy
    return SLSMParams(R=8, Rn=256, eps=1e-3, D=4, m=1.0, mu=64, max_levels=3,
                      merge_budget=1, range_cand=512,
                      tuning=TuningPolicy(mode="adaptive", interval=512,
                                          eps_floor=1e-4))


def writer_stream(seed: int):
    """The killed writer's calls: 16 insert calls (1-800 keys), then
    rounds of a `run_tape` window (`tape_windows`' mix), an insert, three
    lookup batches of WRITER_LOOKUPS keys and a delete call:
    ("insert", keys, vals), ("delete", keys, None), ("tape", chunks,
    None), ("lookup", qs, None); keys are the even keys below
    2 * SCALED_KEYS."""
    rng = np.random.default_rng(seed + 12)
    keys = np.arange(0, 2 * SCALED_KEYS, 2, dtype=np.int32)
    p = writer_params()

    def insert():
        m = int(rng.integers(1, 801))
        return ("insert", rng.choice(keys, m),
                rng.integers(-2 ** 31, 2 ** 31 - 1, m, dtype=np.int32))

    out = [insert() for _ in range(16)]
    while len(out) < WRITER_CALLS:
        window = split_chunks(tape_windows(rng, 1, keys, 800,
                                           fresh=False)[0], p)
        out += [("tape", window, None), insert()]
        out += [("lookup", rng.choice(keys, WRITER_LOOKUPS), None)
                for _ in range(3)]
        out.append(("delete", rng.choice(keys, int(rng.integers(1, 101))),
                    None))
    return out


def writer_records(calls):
    """(call index, keys, vals, wts) of each WAL write record the calls
    make, in order: one an insert or delete call, one a tape write
    chunk."""
    out = []
    for i, (kind, a, b) in enumerate(calls):
        if kind == "insert":
            out.append((i, a, b, np.ones_like(a)))
        elif kind == "delete":
            out.append((i, a, np.zeros_like(a), np.full_like(a, -1)))
        elif kind == "tape":
            out += [(i, ch.keys, ch.vals, ch.wts) for ch in a
                    if ch.kind == "write" and len(ch.keys)]
    return out


def writer_child(directory: str, seed: int, device) -> int:
    """The killed writer's process: the calls of `writer_stream` on a
    durable adaptive engine (fsync on), `voluntary_steps(1)` after each
    tape window; after each call returns, one line `ack <call> <last
    synced seqno>` on stdout. Runs until killed."""
    from repro_torch.engine import SLSM
    from repro_torch.engine import wal as WAL
    eng = SLSM(writer_params(), device=device,
               durability=WAL.Durability(directory, fsync=True))
    for i, (kind, a, b) in enumerate(writer_stream(seed)):
        if kind == "insert":
            eng.insert(a, b)
        elif kind == "delete":
            eng.delete(a)
        elif kind == "tape":
            eng.run_tape(a)
            eng.voluntary_steps(1)
        else:
            eng.lookup_many(a)
        print(f"ack {i} {eng.durability.writer.last_seqno}", flush=True)
    return 0


def killed_writer_phase(device, seed: int):
    """A child process on the card writes through `writer_child`; after a
    seeded number of acknowledged calls it is killed (SIGKILL) and the
    directory restored here on the card: the WAL's write records are a
    prefix of the child's stream that covers every acknowledged call,
    at least one RETUNE is replayed, and every answer equals the oracle
    of that prefix (log-before-ack against a real crash)."""
    import shutil
    import signal

    from repro_torch.engine import SLSM
    from repro_torch.engine import wal as WAL

    t_phase = time.perf_counter()
    wdir = ROOT / "build" / "durable" / "writer"
    shutil.rmtree(wdir, ignore_errors=True)
    kill_after = int(np.random.default_rng(seed + 13).integers(
        *WRITER_KILL_AFTER))
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--seed", str(seed),
           "--durable-writer", str(wdir), "--writer-device", str(device)]
    child = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
    acks = []
    try:
        for line in child.stdout:
            if line.startswith("ack "):
                acks.append(tuple(map(int, line.split()[1:])))
                if len(acks) == kill_after:
                    child.send_signal(signal.SIGKILL)
                    break
    finally:
        if child.poll() is None and len(acks) < kill_after:
            child.kill()
        child.wait(timeout=120)
        child.stdout.close()
    if len(acks) < kill_after or child.returncode != -signal.SIGKILL:
        raise AssertionError(f"killed writer: {len(acks)} acks of "
                             f"{kill_after}, exit {child.returncode}")
    records = WAL.read_wal(wdir / "wal.log")[0]
    got = [WAL.decode_write(r.payload, r.kind) for r in records
           if r.kind in WAL.WRITE_KINDS]
    want = writer_records(writer_stream(seed))
    acked_call, acked_seqno = acks[-1]
    n_acked = sum(1 for i, *_ in want if i <= acked_call)
    if len(got) < n_acked or records[-1].seqno < acked_seqno:
        raise AssertionError(f"killed writer: the WAL holds {len(got)} "
                             f"write records up to seqno "
                             f"{records[-1].seqno}, the acknowledged calls "
                             f"{n_acked} up to seqno {acked_seqno} "
                             f"(calls {acks[-3:]})")
    for j, ((k, v, w), (_, wk, wv, ww)) in enumerate(zip(got, want)):
        if not (np.array_equal(k, wk) and np.array_equal(v, wv)
                and np.array_equal(w, ww)):
            raise AssertionError(f"killed writer: WAL write record {j} is "
                                 "not the stream's")
    retunes = [r.payload.decode() for r in records
               if r.kind == WAL.REC_RETUNE]
    eng = SLSM.restore(wdir, device=device)
    if not retunes or eng.stats["retunes"] < 1:
        raise AssertionError(f"killed writer: no RETUNE replayed "
                             f"({retunes}, {eng.stats['retunes']})")
    oracle = DenseOracle(KEY_BITS)
    for k, v, w in got:
        oracle.apply(k, v, w)
    qs = np.arange(-8, 2 * SCALED_KEYS + 8, dtype=np.int32)
    for i in range(0, qs.size, LOOKUP_BATCH):
        q = qs[i:i + LOOKUP_BATCH]
        oracle.check_lookups(q, *eng.lookup_many(q), "killed writer")
    lo = np.arange(0, 2 * SCALED_KEYS, 2 * SCALED_KEYS // 64, dtype=np.int32)
    wins = np.stack([lo, lo + 256], 1)
    check_scans(oracle, wins, *eng.range_many(wins))
    c, s, tr = eng.aggregate_many(wins)
    for j, (a, b) in enumerate(wins):
        ek, ev = oracle.window(int(a), int(b))
        if tr[j] or int(c[j]) != len(ek) or int(s[j]) != wrap_sum(ev):
            raise AssertionError(f"killed writer: aggregate {a}:{b} differs")
    return dict(acked_calls=len(acks), last_acked_call=acked_call,
                last_acked_seqno=acked_seqno, wal_seqno=records[-1].seqno,
                write_records=len(got), acked_write_records=n_acked,
                retune_records=retunes, replayed=eng.stats["replayed_records"],
                retunes_replayed=eng.stats["retunes"],
                restore_us=eng.stats["restore_us"],
                live_keys=int(oracle.present.sum()),
                phase_s=time.perf_counter() - t_phase)


# --------------------------------------------------------------------------
# sharded phase: S trees in one stacked state, every engine kernel one
# launch for all shards
# --------------------------------------------------------------------------

SHARDS = 4                      # the reference's sweep_shards_4 count
SHARDED_INSERTS = 4_000_000     # in calls of SHARDED_CALL keys; a delete
SHARDED_CALL = 800              # call of as many keys after every tenth
SHARDED_TAPES = 64              # run_tape windows, writes of 1-800 keys
SHARDED_KERNEL_Q = 1024         # queries a shard in the kernel shapes


def sharded_params():
    """The paper's Table 1 widths at max_levels 2: the sharded engine
    allocates every tier of every shard, and level 1 is then the
    deepest (20 runs of 16,179,200 slots, ~5.78 GB a shard); at
    max_levels 3 the deepest level would take ~115 GB a shard."""
    from repro_torch.configs.slsm_paper import paper_params
    return paper_params(max_levels=2, merge_budget=1, range_cand=512)


class step_tally:
    """Within the block, every masked step the sharded engine applies:
    ``(kind, level, shards, heap_merge launches)``."""

    def __init__(self, eng, counter):
        self.eng, self.counter, self.steps = eng, counter, []

    def __enter__(self):
        real = self.eng._apply_step

        def apply(kind, level, mask):
            n0 = self.counter.launches
            out = real(kind, level, mask)
            self.steps.append((kind, level,
                               tuple(int(s) for s in np.flatnonzero(mask)),
                               self.counter.launches - n0))
            return out

        self.eng._apply_step = apply
        return self

    def __exit__(self, *exc):
        del self.eng._apply_step          # the class's method again

    def merges(self):
        return [s for s in self.steps if s[0] != "seal"]


def sharded_queries(eng, rng, pool, per_shard: int):
    """(S, per_shard) lookup keys, each row its shard's: half `pool` keys,
    half absent (odd keys above 2**KEY_BITS)."""
    from repro_torch.engine.sharded import shard_ids
    cand = np.concatenate([
        rng.choice(pool, 16 * per_shard * eng.S),
        rng.integers(2 ** KEY_BITS, 2 ** (KEY_BITS + 1),
                     16 * per_shard * eng.S, dtype=np.int32) | 1])
    sid = shard_ids(cand, eng.S)
    half = per_shard // 2
    rows = []
    for s in range(eng.S):
        mine = cand[sid == s]
        present = mine[mine < 2 ** KEY_BITS][:half]
        absent = mine[mine >= 2 ** KEY_BITS][:per_shard - half]
        rows.append(rng.permutation(np.concatenate([present, absent])))
    return np.stack(rows).astype(np.int32)


def sharded_case(name, shape, launch, plain, singles, work: dict, library,
                 kernel_launches):
    """One shard-batched kernel shape: the one call `launch` (all shards)
    against `plain` bitwise and against `singles` (S single-tree calls,
    one a shard) bitwise, device and wall times of each, and the bound
    (`bound_ms(**work)`)."""
    import torch
    counter, per = kernel_launches
    n0 = counter.launches
    got = launch()
    n1 = counter.launches
    one = singles()
    torch.cuda.synchronize()
    want = plain()
    rec = dict(
        case=f"sharded: {name}", shape=shape,
        launches_a_call=(n1 - n0) // per,
        single_launches=(counter.launches - n1) // per,
        max_abs_err=max_abs_err(got, want),
        single_max_abs_err=max_abs_err(got, one),
        ms=device_ms(launch, 20), wall_ms=wall_ms(launch, 20),
        single_ms=device_ms(singles, 20), single_wall_ms=wall_ms(singles, 20),
        plain_ms=device_ms(plain, 3), bound_ms=bound_ms(**work),
        library_ms=device_ms(library, 10) if library else None)
    log(f"sharded kernel {json.dumps(rec)}")
    if rec["max_abs_err"] or rec["single_max_abs_err"]:
        raise AssertionError(f"sharded {name}: the shard-batched kernel "
                             "differs from its plain version or from one "
                             "launch a shard")
    if rec["launches_a_call"] != 1:
        raise AssertionError(f"sharded {name}: {rec['launches_a_call']} "
                             "launches a call, not one")
    return rec


def sharded_kernel_cases(eng, device, rng, pool):
    """The four engine kernels at the sharded path's shapes, each one
    launch for all shards: bloom_probe over both levels of the fleet's
    filters (S x 20 runs a level) with S x 1,024 keys; fence_lookup over
    the fleet's deepest level (S x 20 runs, 31,600 fences each); a
    heap_merge batch of S level-0 spills (20 x 40,448 each); range_merge
    over S x 32 scan rows of 512 lanes."""
    import torch
    from repro_torch.core import runs as RU
    from repro_torch.core.params import KEY_EMPTY
    from repro_torch.kernels import bloom_probe as KBP
    from repro_torch.kernels import fence_lookup as KFL
    from repro_torch.kernels import heap_merge as KHM
    from repro_torch.kernels import range_merge as KRM
    p, st, s_n = eng.p, eng.state, eng.S
    q_n = SHARDED_KERNEL_Q
    qs = torch.from_numpy(sharded_queries(eng, rng, pool, q_n)).to(device)
    out = {}

    stacks = []
    for level, lv in enumerate(st.levels):
        bits, _, k = p.bloom_geometry(p.level_cap(level), p.level_eps(level))
        stacks.append((lv.blooms, k, bits))
    words = sum(int(bloom_need([(b[s], k, bits) for b, k, bits in stacks],
                               qs[s])[1].numel()) for s in range(s_n))
    rows = sum(b.shape[1] for b, _, _ in stacks) * s_n
    out["bloom_probe"] = sharded_case(
        "both levels of every shard",
        f"S={s_n} x ({', '.join(f'D={b.shape[1]} W={b.shape[2]} k={k}' for b, k, _ in stacks)}), Q={q_n} a shard",
        lambda: KBP.bloom_probe_levels(stacks, qs),
        lambda: [KBP.bloom_probe_plain(b, qs, k, bits)
                 for b, k, bits in stacks],
        lambda: [torch.stack(x) for x in zip(*[
            KBP.bloom_probe_levels([(b[s], k, bits) for b, k, bits in stacks],
                                   qs[s]) for s in range(s_n)])],
        dict(name="bloom_probe", q=q_n, rows=rows // s_n, words=words,
             shards=s_n), None,
        (KBP.bloom_probe_levels, 1))

    last = st.levels[-1]
    stride, mu = p.fence_view(p.max_levels - 1)
    fences = last.fences
    d_n, cap = last.keys.shape[1:]
    f_n = fences.shape[-1]
    rows_k = last.keys.reshape(s_n * d_n, cap)
    qs_d = qs.repeat_interleave(d_n, 0)
    zero = torch.zeros(qs_d.shape, dtype=torch.int64, device=device)
    f, fence_reads = search_reads(fences.reshape(s_n * d_n, f_n), zero, f_n,
                                  qs_d, right=True)
    start = ((f - 1).clamp(0, f_n - 1) * mu).clamp(max=cap - mu)
    off, key_reads = search_reads(rows_k, start, mu, qs_d, right=False)
    fence_words = int(torch.unique(fence_reads).numel())
    key_words = int(torch.unique(key_reads).numel())
    del f, start, off, fence_reads, key_reads, zero
    out["fence_lookup"] = sharded_case(
        "the fleet's deepest level",
        f"S={s_n} x D={d_n}, F={f_n}, cap={cap}, mu={mu}, Q={q_n} a shard",
        lambda: KFL.fence_lookup_many(qs, fences, last.keys, last.counts, mu),
        lambda: KFL.fence_lookup_plain(qs, fences, last.keys, last.counts,
                                       mu),
        lambda: torch.stack([KFL.fence_lookup_many(
            qs[s], fences[s], last.keys[s], last.counts[s], mu)
            for s in range(s_n)]),
        dict(name="fence_lookup", q=q_n, runs=d_n, fence_words=fence_words,
             key_words=key_words, shards=s_n),
        lambda: torch.searchsorted(rows_k, qs_d), (KFL.fence_lookup_many, 1))
    del qs_d

    n_runs, cap0 = p.D, p.level_cap(0)
    fill = p.runs_merged * p.Rn
    lanes = []
    for _ in range(s_n):
        cnt = np.full(n_runs, fill, np.int64)
        cnt[n_runs // 2:] = fill - fill // 9
        kr = sorted_runs(rng, n_runs, cap0, cnt)
        real = kr != KEY_EMPTY
        seqs = np.where(real, rng.permutation(kr.size).reshape(kr.shape), 0)
        wts = np.where(real, rng.choice([-1, 1], kr.shape), 0)
        lanes.append([a.reshape(-1).astype(np.int32) for a in (kr, wts,
                                                               seqs)])
    batch = [torch.from_numpy(np.stack(a)).to(device) for a in zip(*lanes)]
    n = n_runs * cap0
    ix = torch.arange(n, dtype=torch.int32,
                      device=device).expand(s_n, -1).contiguous()
    comp = RU.composite(batch[0], batch[2])
    out["heap_merge"] = sharded_case(
        "a masked spill of every shard",
        f"B={s_n} x {n_runs} runs x {cap0} = {n} lanes a merge",
        lambda: KHM.kway_merge(*batch, ix, n_runs),
        lambda: KHM.kway_merge_plain(*batch, ix, n_runs),
        lambda: tuple(torch.stack(x) for x in zip(*[
            KHM.kway_merge(*(a[s] for a in batch), ix[s], n_runs)
            for s in range(s_n)])),
        dict(name="heap_merge", lanes=s_n * n),
        lambda: torch.sort(comp, dim=1, stable=True),
        (KHM.kway_merge, 2))
    del batch, ix, comp

    n_seg = 1 + p.R + p.D * p.max_levels     # stage, memory runs, levels
    c_n = p.range_cand_eff(p.max_levels)
    k, v, w, s, o = (torch.from_numpy(a).to(device) for a in scan_rows(
        rng, s_n * SCAN_BATCH, c_n, n_seg))
    filled = int(o[:, -1].sum())
    comp = RU.composite(k, s)

    def per_shard():
        parts = [KRM.range_merge(*(a[i * SCAN_BATCH:(i + 1) * SCAN_BATCH]
                                   for a in (k, v, w, s, o)), True)
                 for i in range(s_n)]
        return tuple(torch.cat(x) for x in zip(*parts))

    out["range_merge"] = sharded_case(
        "every shard's scan rows of a batch",
        f"S x Q = {s_n} x {SCAN_BATCH} rows, C={c_n}, P={n_seg}",
        lambda: KRM.range_merge(k, v, w, s, o, True),
        lambda: KRM.range_merge_plain(k, v, w, s, o, True),
        per_shard,
        dict(name="range_merge", rows=k.shape[0], lanes=c_n, filled=filled,
             parts=n_seg),
        lambda: torch.sort(comp, dim=1, stable=True),
        (KRM.range_merge, 1))
    return out


def sharded_phase(device, seed: int, tally, n_inserts: int = SHARDED_INSERTS,
                  n_tapes: int = SHARDED_TAPES, p=None):
    """The sharded engine at the paper's widths, 4 shards, max_levels 2
    (~23 GB of stacked state): `n_inserts` inserts and a tenth as many
    deletes in calls of 800 keys, 1M lookups (half absent) in batches of
    4,096, 2,048 scans and 2,048 aggregates of 256-key windows in
    batches of 32, and `n_tapes` run_tape windows with writes of 1-800
    keys, every answer against the numpy oracle. Launches are counted on
    `tally` from after `warm()`: bloom_probe exactly once a lookup batch
    (tape lookup slots included), fence_lookup at most once a level a
    batch, range_merge once a scan or aggregate batch (and tape range
    slot), heap_merge twice a masked merge step whatever the shards in
    its mask; every shard must have spilled. Then the kernel shapes of
    the path (`sharded_kernel_cases`) and a lookup window's device-busy
    share. Returns (record, kernel cases)."""
    import torch
    from repro_torch.engine import ShardedSLSM
    from repro_torch.kernels import heap_merge as KHM

    t_phase = time.perf_counter()
    p = p or sharded_params()
    rng = np.random.default_rng(seed + 21)
    torch.cuda.reset_peak_memory_stats()
    eng = ShardedSLSM(p, SHARDS, device=device)
    eng.warm()
    state_bytes = sum(t.numel() * t.element_size()
                      for t in eng.state[:-1]) + sum(
        t.numel() * t.element_size() for lv in eng.state.levels for t in lv)
    log(f"sharded: {SHARDS} shards, stacked state {state_bytes} bytes")
    oracle = DenseOracle(KEY_BITS)
    clock = Clock()
    n_ops = 0
    before = dict(tally.counts)
    with tally, step_tally(eng, KHM.kway_merge) as steps:
        for kind, ks, vs in durable_calls(rng, n_inserts, SHARDED_CALL):
            with clock:
                if kind == "insert":
                    eng.insert(ks, vs)
                else:
                    eng.delete(ks)
            (oracle.insert(ks, vs) if kind == "insert"
             else oracle.delete(ks))
            n_ops += ks.size
    t_write = clock.total
    writes = {k: tally.counts[k] - before[k] for k in before}
    merges = steps.merges()
    spilled = {s for kind, _, shards, _ in merges if kind == "spill"
               for s in shards}
    if spilled != set(range(SHARDS)):
        raise AssertionError(f"sharded: shards {sorted(spilled)} spilled, "
                             f"not all {SHARDS}")
    bad = [m for m in merges if m[3] != 2]
    if bad:
        raise AssertionError(f"sharded: masked merge steps with other than "
                             f"two heap_merge launches: {bad[:4]}")
    masked = {}
    for kind, _, shards, _ in merges:
        masked[f"{kind} x {len(shards)}"] = masked.get(
            f"{kind} x {len(shards)}", 0) + 1
    pool = np.flatnonzero(oracle.present).astype(np.int32)

    n_q, n_scan = 256 * LOOKUP_BATCH, 64 * SCAN_BATCH
    before = dict(tally.counts)
    with tally:
        reads = check_reads(eng, oracle, rng, pool, n_q, n_scan)
    got = {k: tally.counts[k] - before[k] for k in before}
    batches, scan_batches = n_q // LOOKUP_BATCH, 2 * n_scan // SCAN_BATCH
    if (got["bloom_probe"] != batches
            or got["fence_lookup"] > p.max_levels * batches
            or got["range_merge"] != scan_batches or got["heap_merge"]):
        raise AssertionError(
            f"sharded reads: launches {got} for {batches} lookup batches "
            f"and {scan_batches} scan/aggregate batches")

    windows = tape_windows(rng, n_tapes, pool, 800)
    before = dict(tally.counts)
    t_clock = Clock()
    with tally, step_tally(eng, KHM.kway_merge) as tsteps:
        for chunks in windows:
            with t_clock:
                results = eng.run_tape(chunks)
            check_tape(oracle, chunks, results, "sharded tape")
    tape = {k: tally.counts[k] - before[k] for k in before}
    kinds = [ch.kind for w in windows for ch in w]
    if (tape["bloom_probe"] != kinds.count("lookup")
            or tape["range_merge"] != kinds.count("range")
            or any(m[3] != 2 for m in tsteps.merges())
            or tape["heap_merge"] != 2 * len(tsteps.merges())):
        raise AssertionError(f"sharded tape: launches {tape} for "
                             f"{kinds.count('lookup')} lookup and "
                             f"{kinds.count('range')} range slots and "
                             f"{len(tsteps.merges())} merge steps")
    merges += tsteps.merges()

    qs = rng.choice(pool, 8 * LOOKUP_BATCH).astype(np.int32)
    busy, by_name = flow_busy(lambda: [
        eng.lookup_many(qs[i:i + LOOKUP_BATCH])
        for i in range(0, qs.size, LOOKUP_BATCH)])
    busy["top"] = [(k[:48], round(us / 1e3, 4))
                   for k, us in by_name.most_common(6)]
    cases = sharded_kernel_cases(eng, device, rng, pool)
    rec = dict(
        shards=SHARDS, state_bytes=state_bytes, write_ops=n_ops,
        write_s=t_write, write_ops_per_s=n_ops / t_write,
        write_launches=writes, masked_merge_steps=masked,
        merge_steps=len(merges),
        shard_occupancy=eng.shard_occupancy().tolist(),
        **reads, read_launches=got, tape_windows=n_tapes,
        tape_ms_a_window=t_clock.total * 1e3 / n_tapes,
        tape_launches=tape, tape_slots={k: kinds.count(k) for k in
                                        ("write", "lookup", "range")},
        lookup_window=busy, live_keys=int(oracle.present.sum()),
        stats={k: int(v) for k, v in eng.stats.items()},
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        phase_s=time.perf_counter() - t_phase)
    del eng
    torch.cuda.empty_cache()
    return rec, cases


def sharded_cascade_phase(device, seed: int, n_rounds: int = 200):
    """The cascade's scaled geometry on 4 shards with adaptive tuning and
    a WAL: `n_rounds` rounds of 3,000 inserts and 1,000 deletes over
    65,536 keys with a lookup burst after every twentieth (so the tuner
    moves), a snapshot halfway; it must compact the deepest level, with
    annihilation, in two shards or more and make a lockstep RETUNE. The
    engine is then dropped without close(), its WAL cut inside the last
    record, restored on the card, and every answer held against the
    oracle of every call but the torn one."""
    import copy
    import shutil

    import torch
    from repro_torch.core.oracle import DictOracle
    from repro_torch.core.params import SLSMParams, TuningPolicy
    from repro_torch.engine import ShardedSLSM
    from repro_torch.engine import wal as WAL
    from repro_torch.kernels import heap_merge as KHM

    t_phase = time.perf_counter()
    p = SLSMParams(R=8, Rn=256, eps=1e-3, D=4, m=1.0, mu=64, max_levels=3,
                   merge_budget=1, range_cand=512,
                   tuning=TuningPolicy(mode="adaptive", interval=512,
                                       eps_floor=1e-4))
    root = ROOT / "build" / "sharded_cascade"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(seed + 22)
    eng = ShardedSLSM(p, SHARDS, device=device,
                      durability=WAL.Durability(root, fsync=False))
    oracle = DictOracle()
    last = p.max_levels - 1
    annihilated = {}
    with step_tally(eng, KHM.kway_merge) as steps:
        real = eng._apply_step

        def apply(kind, level, mask):
            if kind != "compact":
                return real(kind, level, mask)
            idx = np.flatnonzero(mask)
            rows_in = eng.state.levels[last].counts.cpu().numpy()[idx].sum(1)
            real(kind, level, mask)
            rows_out = eng.state.levels[last].counts.cpu().numpy()[idx, 0]
            for s, a, b in zip(idx, rows_in, rows_out):
                annihilated[int(s)] = annihilated.get(int(s), 0) + int(a - b)

        eng._apply_step = apply
        for r in range(n_rounds):
            ks = rng.integers(0, 2 ** 16, 3000, dtype=np.int32)
            vs = rng.integers(-2 ** 31, 2 ** 31 - 1, 3000, dtype=np.int32)
            dels = rng.integers(0, 2 ** 16, 1000, dtype=np.int32)
            final = r == n_rounds - 1
            eng.insert(ks, vs)
            oracle.insert(ks, vs)
            if final:                   # the torn record: not in the oracle
                durable = copy.deepcopy(oracle)
            eng.delete(dels)
            oracle.delete(dels)
            if r % 20 == 19:
                for _ in range(4):
                    eng.lookup_many(rng.integers(0, 2 ** 16, LOOKUP_BATCH,
                                                 dtype=np.int32))
            if r == n_rounds // 2:
                eng.snapshot()
    stats = {k: int(v) for k, v in eng.stats.items()}
    compacted = sorted(s for s, n in annihilated.items() if n > 0)
    if len(compacted) < 2 or stats["retunes"] < 1:
        raise AssertionError(f"sharded cascade: compactions with "
                             f"annihilation in shards {compacted}, "
                             f"{stats['retunes']} retunes")
    del eng                             # the crash: no close()
    torch.cuda.empty_cache()
    wal_path = root / "wal.log"
    offsets = WAL.record_offsets(wal_path)
    writes = [o for o in offsets if o[0].kind in WAL.WRITE_KINDS]
    rec_last, start, end = writes[-1]
    cut = start + int(rng.integers(1, end - start))
    with open(wal_path, "r+b") as f:
        f.truncate(cut)
    t0 = time.perf_counter()
    eng = ShardedSLSM.restore(root, device=device)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    qs = np.arange(-8, 2 ** 16 + 8, dtype=np.int32)
    v, f = eng.lookup_many(qs)
    vo, fo = durable.lookup(qs)
    if not (np.array_equal(f, fo) and np.array_equal(v[f], vo[fo])):
        raise AssertionError("sharded cascade: restored lookups differ from "
                             "the oracle of the durable prefix")
    lo = rng.integers(0, 2 ** 16, 64, dtype=np.int32)
    wins = np.stack([lo, lo + rng.integers(1, 400, 64, dtype=np.int32)], 1)
    k, vv, c, tr = eng.range_many(wins)
    ca, sa, ta = eng.aggregate_many(wins)
    for i, (a, b) in enumerate(wins):
        ek, ev = durable.range(int(a), int(b))
        ci = int(c[i])
        if (not tr[i] and ci != len(ek)) or ci > len(ek) or not (
                np.array_equal(k[i, :ci], ek[:ci])
                and np.array_equal(vv[i, :ci], ev[:ci])):
            raise AssertionError(f"sharded cascade scan {a}:{b} differs")
        if not ta[i] and (int(ca[i]), int(sa[i])) != durable.aggregate(
                int(a), int(b)):
            raise AssertionError(f"sharded cascade aggregate {a}:{b} differs")
    out = dict(
        rounds=n_rounds, compactions=stats["compactions"],
        annihilated_rows_by_shard=annihilated, retunes=stats["retunes"],
        spills=stats["spills"], merge_steps=len(steps.merges()),
        torn_record=dict(seqno=rec_last.seqno, cut=cut, start=start,
                         end=end),
        restore_wall_ms=restore_s * 1e3,
        replayed_records=eng.stats["replayed_records"],
        tuner_active=eng.tuner.active, live_keys=len(durable.d),
        phase_s=time.perf_counter() - t_phase)
    del eng
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# replicated phase: a quorum leader, two followers and two servers on the
# card, through the closed-loop load generator
# --------------------------------------------------------------------------

REPL_WRITES = 1_000_000         # keys written through the leader's server
REPL_LOOKUPS = 200_000          # keys looked up there, at least
REPL_CLIENTS = 16               # closed-loop clients; the last
REPL_FOLLOWER_CLIENTS = 4       # four read from the follower's server
REPL_CHECK_LOOKUPS = 1 << 20    # a follower's reads after converge
REPL_CHECK_SCANS = 2048
REPL_KILL_AFTER = (200, 401)    # records the follower applies before the
                                # replica kill's SIGKILL
REPL_KILL_WINDOWS = 4000        # the killed leader's windows (far past it)
REPL_LEASE_S = 2.0


def repl_requests(rng, n_writes: int, n_lookups: int, follower_every: int,
                  n_followers: int):
    """The closed loop's stream, `follower_every` requests a round of
    which the last `n_followers` go to the follower's server. Leader
    requests: writes of 1-800 uniform keys of the paper's key space (a
    tenth of them deletes of written keys), lookups of 1-64 keys (half
    written, half absent), ranges of 1-32 windows of 256 keys, until
    `n_writes` keys are written and `n_lookups` looked up. Follower
    requests: lookups and ranges alike. Returns the `Request`s."""
    from repro_torch.serve import Request
    written = np.empty(n_writes + 800, np.int32)
    n_w = n_q = 0

    def read():
        nonlocal n_q
        if rng.random() < 0.97:
            m = int(rng.integers(1, 65))
            qs = rng.integers(2 ** KEY_BITS, 2 ** (KEY_BITS + 1), m,
                              dtype=np.int32)
            if n_w:
                half = rng.random(m) < 0.5
                qs[half] = written[rng.integers(0, n_w, int(half.sum()))]
            return Request("lookup", qs), m
        m = int(rng.integers(1, 33))
        lo = rng.integers(0, 2 ** KEY_BITS - 256, m, dtype=np.int32)
        return Request("range", lo, lo + 256), 0

    leader, follower = [], []
    while n_w < n_writes or n_q < n_lookups:
        if rng.random() < 0.27 and n_w < n_writes:
            m = int(rng.integers(1, 801))
            if rng.random() < 0.1 and n_w:
                leader.append(Request("delete", written[rng.integers(
                    0, n_w, m)]))
            else:
                ks = rng.integers(0, 2 ** KEY_BITS, m, dtype=np.int32)
                written[n_w:n_w + m] = ks
                n_w += m
                leader.append(Request("insert", ks, rng.integers(
                    -2 ** 31, 2 ** 31 - 1, m, dtype=np.int32)))
        else:
            req, m = read()
            leader.append(req)
            n_q += m
    per = follower_every - n_followers
    for _ in range(-(-len(leader) // per) * n_followers):
        follower.append(read()[0])
    out = []
    for r in range(-(-len(leader) // per)):
        out += leader[r * per:(r + 1) * per]
        out += follower[r * n_followers:(r + 1) * n_followers]
    return out


class ReplicatedFront:
    """The closed loop's server: routes client `c` to the follower's
    server when ``c >= n_leader_clients``, else to the leader's, and
    checks every reply as it comes. One `pump(force=True)` serves the
    leader's window (its reads against the oracle at their point in the
    stream; its writes held for the quorum), lets follower 1 apply, serves
    the follower server's window (follower 0's reads against the oracle
    of the leader's records up to follower 0's applied watermark; then
    follower 0 applies), and pumps the leader's server idle, which drains
    the acks and releases the held writes: each released write's window
    watermark must lie at or below `quorum_seqno()` and in a follower's
    durable log."""

    def __init__(self, leader, lsrv, fsrv, fols, oracle, n_leader_clients,
                 tallies):
        import collections
        self.leader, self.lsrv, self.fsrv, self.fols = (leader, lsrv, fsrv,
                                                        fols)
        self.oracle, self.f_oracle = oracle, DenseOracle(KEY_BITS)
        self.n_leader = n_leader_clients
        self.tallies = tallies
        self.records, self._next_record = [], 0
        self.l_new, self.f_new, self.held = [], [], {}
        self._assigned = 0
        self.syncs = collections.Counter()
        self.lat = collections.defaultdict(list)
        self.lag_peak = [0, 0]
        self.apply_clock = Clock()
        self.acked_writes = 0
        dur = leader.drv.durability
        real = dur.log_write

        def log_write(keys, vals, wts):     # the leader's records, in order
            seqno = real(keys, vals, wts)
            self.records.append((seqno, keys.copy(), vals.copy(),
                                 wts.copy()))
            return seqno

        dur.log_write = log_write

    @property
    def counters(self):
        return self.lsrv.counters + self.fsrv.counters

    def submit(self, client, kind, keys, vals=None):
        follower = int(client.rsplit("-", 1)[1]) >= self.n_leader
        t = (self.fsrv if follower else self.lsrv).submit(client, kind, keys,
                                                          vals)
        (self.f_new if follower else self.l_new).append(t)
        return t

    def serve_leader(self, force: bool = True) -> int:
        """The leader server's window; its writes are held, tagged with
        the window's watermark (the leader's last seqno after it)."""
        with self.tallies["leader"]:
            n, sites = count_syncs(lambda: self.lsrv.pump(force=force))
        self.syncs.update(sites)
        wm = self.leader.drv.durability.writer.last_seqno
        for t in self.l_new[self._assigned:]:
            if t.kind in ("insert", "delete"):
                if t.done:
                    raise AssertionError("a quorum write replied unheld")
                self.held[id(t)] = (t, wm)
        self._assigned = len(self.l_new)
        return n

    def check_leader(self) -> None:
        """The leader window's tickets in stream order: writes into the
        oracle (and held), reads against it."""
        for t in self.l_new:
            if t.kind == "insert":
                self.oracle.insert(t.keys, t.vals)
            elif t.kind == "delete":
                self.oracle.delete(t.keys)
            elif t.kind == "lookup":
                self.oracle.check_lookups(t.keys, *t.result, "leader reply")
            else:
                check_scans(self.oracle, np.stack([t.keys, t.vals], 1),
                            *t.result)
        self.l_new, self._assigned = [], 0
        st = self.leader.stats()
        self.lag_peak = [max(self.lag_peak[0], st["follower_lag_records"]),
                         max(self.lag_peak[1], st["follower_lag_bytes"])]

    def serve_followers(self, force: bool = True) -> None:
        fol0, fol1 = self.fols
        with self.tallies["followers"]:
            with self.apply_clock:
                fol1.pump()
            wm = fol0.last_seqno
            self.fsrv.pump(force=force)
        if wm > self.leader.drv.durability.writer.last_seqno:
            raise AssertionError("a follower ahead of its leader")
        while (self._next_record < len(self.records)
               and self.records[self._next_record][0] <= wm):
            self.f_oracle.apply(*self.records[self._next_record][1:])
            self._next_record += 1
        for t in self.f_new:
            if t.kind == "lookup":
                self.f_oracle.check_lookups(t.keys, *t.result,
                                            "follower reply")
            else:
                check_scans(self.f_oracle, np.stack([t.keys, t.vals], 1),
                            *t.result)
            self.lat["follower " + t.kind].append(t.latency_s)
        self.f_new = []

    def release(self) -> None:
        with self.tallies["leader"]:
            self.lsrv.pump()
        q = self.leader.quorum_seqno()
        durable = max(f.last_seqno for f in self.fols)
        for key, (t, w) in list(self.held.items()):
            if not t.done:
                continue
            if t.error is not None:
                raise AssertionError(f"a held write failed: {t.error}")
            if w > q or w > durable:
                raise AssertionError(f"write acknowledged at watermark {w}"
                                     f" past quorum_seqno {q} or the "
                                     f"followers' durable {durable}")
            del self.held[key]
            self.acked_writes += 1
            self.lat["leader " + t.kind].append(t.latency_s)

    def pump(self, force: bool = False) -> int:
        n = self.serve_leader(force)
        for t in self.l_new:
            if t.kind in ("lookup", "range"):
                self.lat["leader " + t.kind].append(t.latency_s)
        self.check_leader()
        self.serve_followers(force)
        self.release()
        return n


def latency_by_kind(lat: dict) -> dict:
    out = {}
    for kind, ts in sorted(lat.items()):
        us = np.asarray(ts) * 1e6
        out[kind] = dict(n=int(us.size), p50_us=float(np.percentile(us, 50)),
                         p99_us=float(np.percentile(us, 99)))
    return out


def same_reads(engines, oracle, rng, pool, n_q: int, n_scan: int,
               tallies=None) -> list:
    """`n_q` lookups (half `pool` keys, half absent) in batches of
    LOOKUP_BATCH, `n_scan` scans and `n_scan` aggregates of 256-key
    windows in batches of SCAN_BATCH, through every engine: each answer
    bitwise the first engine's, which is held against `oracle`. With
    `tallies` (one an engine, None for none), each counts its engine's
    launches. Returns each later engine's rates."""
    import contextlib
    qs = np.concatenate([pool[rng.integers(0, pool.size, n_q // 2)],
                         rng.integers(2 ** KEY_BITS, 2 ** (KEY_BITS + 1),
                                      n_q - n_q // 2, dtype=np.int32)])
    qs = rng.permutation(qs).astype(np.int32)
    lo = rng.integers(0, 2 ** KEY_BITS - 256, 2 * n_scan, dtype=np.int32)
    wins = np.stack([lo, lo + 256], axis=1)
    out = []
    first = None
    for e, eng in enumerate(engines):
        ctx = (tallies[e] if tallies is not None and tallies[e] is not None
               else contextlib.nullcontext())
        clocks = [Clock(), Clock(), Clock()]
        got = []
        with ctx:
            for i in range(0, n_q, LOOKUP_BATCH):
                with clocks[0]:
                    got.append(eng.lookup_many(qs[i:i + LOOKUP_BATCH]))
            for i in range(0, n_scan, SCAN_BATCH):
                with clocks[1]:
                    got.append(eng.range_many(wins[i:i + SCAN_BATCH]))
            for i in range(n_scan, 2 * n_scan, SCAN_BATCH):
                with clocks[2]:
                    got.append(eng.aggregate_many(wins[i:i + SCAN_BATCH]))
        if first is None:
            first = got
            n_lb = -(-n_q // LOOKUP_BATCH)
            for j, (v, f) in enumerate(got[:n_lb]):
                oracle.check_lookups(qs[j * LOOKUP_BATCH:
                                        (j + 1) * LOOKUP_BATCH], v, f,
                                     "reads after converge")
            for j, res in enumerate(got[n_lb:n_lb + n_scan // SCAN_BATCH]):
                check_scans(oracle, wins[j * SCAN_BATCH:(j + 1) * SCAN_BATCH],
                            *res)
            aggs = got[n_lb + n_scan // SCAN_BATCH:]
            for j, (c, s, tr) in enumerate(aggs):
                base = n_scan + j * SCAN_BATCH
                for k, (a, b) in enumerate(wins[base:base + SCAN_BATCH]):
                    ek, ev = oracle.window(int(a), int(b))
                    if not tr[k] and (int(c[k]) != len(ek)
                                      or int(s[k]) != wrap_sum(ev)):
                        raise AssertionError(f"aggregate {a}:{b} differs")
            continue
        for j, (g, w) in enumerate(zip(got, first)):
            if not all(np.array_equal(a, b) for a, b in zip(g, w)):
                raise AssertionError(f"engine {e}: read batch {j} differs "
                                     "from the leader's")
        out.append(dict(lookups_per_s=n_q / clocks[0].total,
                        scans_per_s=n_scan / clocks[1].total,
                        aggregates_per_s=n_scan / clocks[2].total))
    return out


def write_records(path, WAL) -> list:
    """(keys, vals, wts) of each write record of a `wal.log`."""
    return [WAL.decode_write(r.payload, r.kind)
            for r in WAL.read_wal(path)[0] if r.kind in WAL.WRITE_KINDS]


def replicated_phase(device, seed: int, tallies, n_writes: int = REPL_WRITES,
                     n_lookups: int = REPL_LOOKUPS, p=None,
                     n_check: int = REPL_CHECK_LOOKUPS,
                     n_check_scans: int = REPL_CHECK_SCANS):
    """A durable leader (`p`: the paper's widths at max_levels 2, a WAL
    fsynced under build/replicated) under `Leader(ack_mode="quorum",
    quorum=1)` on a fake clock, two followers from `add_follower` on the
    card, a leader `Server` and a follower `Server` (over follower 0),
    driven by `closed_loop` with REPL_CLIENTS clients (`ReplicatedFront`
    checks every reply and every acknowledgement). Then two leader
    windows and two follower applies under the profiler, `converge`, each
    follower's log against the leader's byte for byte and its reads
    bitwise against the leader's and the oracle; then the lease expires:
    exactly one follower promotes, the old leader is fenced by the fence
    ack (its held write fails with `QuorumAckError`), the promoted leader
    answers as the oracle of its WAL's write records, the other follower
    rejoins it and the old leader's place is taken by a fresh bootstrap,
    and writes at epoch 1 are acknowledged under quorum. `tallies`
    ("leader", "followers") count the launches of each side."""
    import gc
    import shutil

    import torch
    from repro_torch.configs.slsm_paper import paper_params
    from repro_torch.engine import SLSM
    from repro_torch.engine import replication as R
    from repro_torch.engine import wal as WAL
    from repro_torch.serve import QuorumAckError, Server, closed_loop

    t_phase = time.perf_counter()
    p = p or paper_params(max_levels=2, merge_budget=1, range_cand=512)
    root = ROOT / "build" / "replicated"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rec = dict(directory=str(root.relative_to(ROOT)), fs_type=fs_type(root))
    log(f"replicated: WAL directories under {rec['directory']} on "
        f"{rec['fs_type']}")
    rng = np.random.default_rng(seed + 31)
    torch.cuda.reset_peak_memory_stats()
    fake = FakeClock()
    # no snapshot in idle gaps: one of a tree at these widths is ~5.8 GB
    eng = SLSM(p, device=device, durability=WAL.Durability(
        root / "leader", fsync=True, snapshot_every_bytes=1 << 62))
    leader = R.Leader(eng, ack_mode="quorum", quorum=1, lease_s=REPL_LEASE_S,
                      clock=fake)
    fols = [leader.add_follower(root / f"f{i}", fsync=True, auto_promote=True,
                                clock=fake) for i in range(2)]
    for f in fols:
        f.drv.durability.snapshot_every_bytes = 1 << 62
    lsrv = Server(eng, role="leader")
    fsrv = Server(fols[0].drv, role="follower")
    for srv in (lsrv, fsrv):
        srv.warm()
    fols[1].drv.warm()
    n_leader = REPL_CLIENTS - REPL_FOLLOWER_CLIENTS
    reqs = repl_requests(rng, n_writes, n_lookups, REPL_CLIENTS,
                         REPL_FOLLOWER_CLIENTS)
    oracle = DenseOracle(KEY_BITS)
    front = ReplicatedFront(leader, lsrv, fsrv, fols, oracle, n_leader,
                            tallies)
    fsyncs = fsync_clock()
    with fsyncs:
        loop = closed_loop(front, reqs, REPL_CLIENTS)
    if front.held:
        raise AssertionError(f"{len(front.held)} writes never acknowledged")
    n_req = {k: sum(1 for r in reqs if r.kind == k)
             for k in ("insert", "delete", "lookup", "range")}
    write_keys = sum(r.keys.size for r in reqs
                     if r.kind in ("insert", "delete"))
    rec.update(
        requests=n_req, write_keys=write_keys,
        leader_lookup_keys=int(sum(r.keys.size for i, r in enumerate(reqs)
                                   if r.kind == "lookup"
                                   and i % REPL_CLIENTS < n_leader)),
        closed_loop={k: loop[k] for k in ("clients", "ops", "requests",
                                          "wall_s", "ops_per_s", "p50_us",
                                          "p99_us", "windows",
                                          "dispatches")},
        acked_writes_per_s=write_keys / loop["wall_s"],
        acked_write_requests=front.acked_writes,
        latency_by_kind=latency_by_kind(front.lat),
        leader_overall=lsrv.stats()["overall"],
        leader_windows=lsrv.counters["windows"],
        follower_windows=fsrv.counters["windows"],
        blocking_reads_a_window=(sum(front.syncs.values())
                                 / lsrv.counters["windows"]),
        blocking_reads_by_site=dict(front.syncs.most_common(8)),
        records=len(front.records),
        follower_apply_records_per_s=(fols[1].counters["applied_records"]
                                      / front.apply_clock.total),
        follower_apply_ops_per_s=(sum(r[1].size for r in front.records
                                      if r[0] <= fols[1].last_seqno)
                                  / front.apply_clock.total),
        lag_peak_records=front.lag_peak[0], lag_peak_bytes=front.lag_peak[1])
    if rec["leader_lookup_keys"] < n_lookups or write_keys < n_writes:
        raise AssertionError(f"replicated: the stream is short {n_req}")

    # one leader window and one follower apply under the profiler each
    wins = [[r for r in repl_requests(np.random.default_rng(seed + 32 + i),
                                      4000, 1, REPL_CLIENTS, 0)][:n_leader]
            for i in range(2)]

    def leader_window():
        for r in wins.pop(0):
            front.submit("client-0", r.kind, r.keys, r.vals)
        front.serve_leader()

    with tallies["leader"]:
        rec["leader_window_busy"], _ = flow_busy(leader_window)
    front.check_leader()
    appliers = list(fols)

    def follower_apply():
        appliers.pop(0).pump()

    with tallies["followers"]:
        rec["follower_apply_busy"], _ = flow_busy(follower_apply)
    front.release()
    st = leader.stats()
    rec.update(lag_before_converge_records=st["follower_lag_records"],
               lag_before_converge_bytes=st["follower_lag_bytes"])
    with tallies["followers"]:
        rounds = R.converge(leader, *fols)
    front.release()
    if front.held:
        raise AssertionError("writes held after converge")
    st = leader.stats()
    rec.update(converge_rounds=rounds,
               lag_after_converge_records=st["follower_lag_records"],
               lag_after_converge_bytes=st["follower_lag_bytes"],
               quorum_seqno=st["quorum_seqno"], last_seqno=st["last_seqno"],
               shipped_records=st["shipped_records"],
               shipped_bytes=st["shipped_bytes"],
               fsyncs=fsyncs.count,
               fsync_ms_a_sync=fsyncs.total * 1e3 / max(fsyncs.count, 1),
               spills={"leader": eng.stats["spills"],
                       **{f"f{i}": f.drv.stats["spills"]
                          for i, f in enumerate(fols)}})
    if st["follower_lag_records"] or st["quorum_seqno"] != st["last_seqno"]:
        raise AssertionError(f"replicated: not converged {st}")
    if min(rec["spills"].values()) < 1:
        raise AssertionError(f"replicated: a tree never spilled "
                             f"{rec['spills']}")
    wal = (root / "leader" / "wal.log").read_bytes()
    for i in range(2):
        if (root / f"f{i}" / "wal.log").read_bytes() != wal:
            raise AssertionError(f"follower {i}'s wal.log is not the "
                                 "leader's")
    rec["wal_bytes"] = len(wal)

    pool = np.flatnonzero(oracle.present).astype(np.int32)
    read_tallies = [tallies["leader"].fresh() for _ in range(3)]
    rates = same_reads([eng, *(f.drv for f in fols)], oracle, rng, pool,
                       n_check, n_check_scans, read_tallies)
    tallies["leader"].add(read_tallies[0])
    for i, (t, r) in enumerate(zip(read_tallies[1:], rates)):
        tallies["followers"].add(t)
        want = dict(bloom_probe=-(-n_check // LOOKUP_BATCH),
                    range_merge=2 * (n_check_scans // SCAN_BATCH))
        if any(t.counts[k] != n for k, n in want.items()):
            raise AssertionError(f"follower {i}'s reads launched "
                                 f"{t.counts}, expected {want}")
        rec[f"f{i}_reads"] = dict(**r, launches=t.counts)

    # failover: one heartbeat in cadence (both followers then hold one
    # roster, both acks at the tip), then the leader falls silent
    fake.advance(leader.heartbeat_s)
    with tallies["followers"]:
        leader.pump()
        for f in fols:
            f.pump()
    if [f.succession_rank() for f in fols] != [0, 1]:
        raise AssertionError(f"replicated: roster {fols[0].roster}")
    fake.advance(3 * REPL_LEASE_S)
    with tallies["followers"]:
        fols[1].pump()
        t0 = time.perf_counter()
        fsrv.pump()
        rec["promote_wall_ms"] = (time.perf_counter() - t0) * 1e3
    new = fols[0].new_leader
    if (new is None or fols[1].promoted
            or [f.counters["auto_promotions"] for f in fols] != [1, 0]):
        raise AssertionError("replicated: not exactly follower 0 promoted")
    if fsrv.stats()["role"] != "leader":
        raise AssertionError("the promoted follower's server is no leader")
    # the old leader, still alive, writes on: the fence ack deposes it
    lost = lsrv.submit("old", "insert", np.array([1, 3], np.int32),
                       np.array([5, 7], np.int32))
    with tallies["leader"]:
        lsrv.pump(force=True)
    fsrv.pump()                         # the new leader's fence ack
    lsrv.pump()                         # epoch 1 > 0: deposed, fenced
    if not (leader.deposed and eng.fenced
            and isinstance(lost.error, QuorumAckError)
            and lsrv.stats()["role"] == "follower"):
        raise AssertionError("replicated: the old leader was not fenced")
    try:
        eng.insert(np.array([9], np.int32), np.array([9], np.int32))
    except RuntimeError as e:
        if "fenced" not in str(e):
            raise
    else:
        raise AssertionError("a fenced leader took a write")
    # the promoted leader answers as the oracle of its WAL's writes
    prefix = DenseOracle(KEY_BITS)
    for k, v, w in write_records(root / "f0" / "wal.log", WAL):
        prefix.apply(k, v, w)
    if not (np.array_equal(prefix.present, oracle.present)
            and np.array_equal(prefix.val[prefix.present],
                               oracle.val[oracle.present])):
        raise AssertionError("the promoted follower's WAL prefix is not "
                             "every acknowledged write")
    rec["promoted_reads"] = check_reads(new.drv, prefix, rng, pool,
                                        16 * LOOKUP_BATCH, 8 * SCAN_BATCH)
    # re-form: follower 1 follows the new leader, the old leader's place
    # is a fresh bootstrap
    del lsrv, eng, leader, front
    gc.collect()
    torch.cuda.empty_cache()
    link = R.QueueLink()
    new.attach(link.leader, R.Cursor(
        0, fols[1].last_seqno + 1, int(new.drv.durability.writer.epoch)))
    fols[1].reattach(link.follower)
    t0 = time.perf_counter()
    rejoined = new.add_follower(root / "rejoined", fsync=True)
    torch.cuda.synchronize()
    rec["bootstrap_wall_ms"] = (time.perf_counter() - t0) * 1e3
    rejoined.drv.durability.snapshot_every_bytes = 1 << 62
    ks = rng.integers(0, 2 ** KEY_BITS, 3 * 800, dtype=np.int32)
    vs = rng.integers(-2 ** 31, 2 ** 31 - 1, ks.size, dtype=np.int32)
    new_writes = [fsrv.submit("new", "insert", ks[i:i + 800], vs[i:i + 800])
                  for i in range(0, ks.size, 800)]
    with tallies["followers"]:
        fsrv.pump(force=True)
        if any(t.done for t in new_writes):
            raise AssertionError("a quorum write replied unheld")
        for f in (fols[1], rejoined):
            f.pump()
        fsrv.pump()
    if not all(t.done and t.error is None for t in new_writes):
        raise AssertionError("writes at the new epoch were not acknowledged")
    oracle.insert(ks, vs)
    last = WAL.read_wal(root / "f0" / "wal.log")[0][-1]
    if last.epoch != 1:
        raise AssertionError(f"the new leader logs at epoch {last.epoch}")
    with tallies["followers"]:
        R.converge(new, fols[1], rejoined)
    wal = (root / "f0" / "wal.log").read_bytes()
    for name in ("f1", "rejoined"):
        if (root / name / "wal.log").read_bytes() != wal:
            raise AssertionError(f"{name}'s log is not the new leader's")
    same_reads([new.drv, fols[1].drv, rejoined.drv], oracle, rng,
               np.flatnonzero(oracle.present).astype(np.int32),
               16 * LOOKUP_BATCH, 4 * SCAN_BATCH)
    rec.update(new_epoch=last.epoch, rejoined_replayed=rejoined.drv.stats[
        "replayed_records"], peak_memory=torch.cuda.max_memory_allocated(),
        follower_counters=[dict(f.counters) for f in fols],
        phase_s=time.perf_counter() - t_phase)
    del new, rejoined, fols, fsrv
    gc.collect()
    torch.cuda.empty_cache()
    return rec


class FakeClock:
    """Injected monotonic time for leases: it moves when told to."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# --------------------------------------------------------------------------
# replica kill: a leader server in a child process, SIGKILLed mid-stream
# --------------------------------------------------------------------------

def cascade_params(merge_budget: int = 0):
    """The cascade's scaled geometry (its deepest level holds 131,072)."""
    from repro_torch.core.params import SLSMParams
    return SLSMParams(R=8, Rn=256, eps=1e-3, D=4, m=1.0, mu=64, max_levels=3,
                      merge_budget=merge_budget, range_cand=512)


def replica_windows(seed: int):
    """The killed leader's windows: 8 requests each — writes of 1-800
    even keys below 2 * SCALED_KEYS (a tenth deletes), lookups of 1-64
    keys, ranges of 1-4 windows of 256 keys."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed + 33)
    keys = np.arange(0, 2 * SCALED_KEYS, 2, dtype=np.int32)
    out = []
    for _ in range(REPL_KILL_WINDOWS):
        window = []
        for _ in range(8):
            u = rng.random()
            if u < 0.5:
                m = int(rng.integers(1, 801))
                ks = rng.choice(keys, m)
                window.append(Request("delete", ks) if rng.random() < 0.1
                              else Request("insert", ks, rng.integers(
                                  -2 ** 31, 2 ** 31 - 1, m, dtype=np.int32)))
            elif u < 0.9:
                window.append(Request("lookup", rng.choice(
                    keys, int(rng.integers(1, 65))) | 1))
            else:
                lo = rng.choice(keys, int(rng.integers(1, 5)))
                window.append(Request("range", lo, lo + 256))
        out.append(window)
    return out


def replica_records(seed: int):
    """The write records the killed leader's windows log, in order: each
    window coalesced as its server does, one record a write chunk."""
    from repro_torch.engine.tape import write_lanes
    from repro_torch.serve import coalesce
    p = cascade_params()
    out = []
    for window in replica_windows(seed):
        for ch in coalesce(p, window)[0]:
            if ch.kind == "write":
                out.append(write_lanes(ch))
    return out


def replica_leader_child(directory: str, port: int, seed: int,
                         device) -> int:
    """The killed leader's process: a durable leader (fsync on) at the
    cascade's geometry under `Leader(ack_mode="quorum", quorum=1)`; it
    bootstraps `directory`/follower, dials the parent's listener on
    `port`, and serves `replica_windows` through a `Server`, at most 8
    windows ahead of the follower's acks; each window whose writes are
    acknowledged prints `ack <window> <watermark>`. Runs until killed."""
    from repro_torch.engine import SLSM
    from repro_torch.engine import replication as R
    from repro_torch.engine import wal as WAL
    from repro_torch.serve import Server
    root = Path(directory)
    eng = SLSM(cascade_params(), device=device, durability=WAL.Durability(
        root / "leader", fsync=True, snapshot_every_bytes=1 << 62))
    leader = R.Leader(eng, ack_mode="quorum", quorum=1)
    cursor = leader.bootstrap(root / "follower")
    leader.attach(R.connect("127.0.0.1", port, timeout=120.0), cursor)
    srv = Server(eng, role="leader")
    held = []
    for i, window in enumerate(replica_windows(seed)):
        tickets = [srv.submit("child", r.kind, r.keys, r.vals)
                   for r in window]
        srv.pump(force=True)
        writes = [t for t in tickets if t.kind in ("insert", "delete")]
        if writes:
            held.append((i, eng.durability.writer.last_seqno, writes))
        while True:
            srv.pump()
            while held and all(t.done for t in held[0][2]):
                j, wm, ts = held.pop(0)
                if any(t.error is not None for t in ts):
                    print(f"failed {j} {wm}", flush=True)
                else:
                    print(f"ack {j} {wm}", flush=True)
            if len(held) <= 8:
                break
            time.sleep(1e-3)
    return 0


def replica_kill_phase(device, seed: int, tally):
    """A leader `Server` in a child process (`replica_leader_child`)
    ships over a localhost socket to a `Follower` here on the card; after
    a seeded 200-400 applied records the child is SIGKILLed, the torn
    remainder pumped, and the follower promoted. It must answer bitwise
    as a fresh volatile engine fed the write records of its own WAL,
    which must be a prefix of the child's stream holding every window the
    child printed as acknowledged (zero RPO under quorum 1), and take
    writes at epoch 1. `tally` counts the follower's launches."""
    import queue
    import shutil
    import signal
    import threading

    import torch
    from repro_torch.engine import SLSM
    from repro_torch.engine import replication as R
    from repro_torch.engine import wal as WAL
    from repro_torch.engine.tape import TapeChunk

    t_phase = time.perf_counter()
    root = ROOT / "build" / "replica_kill"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    kill_after = int(np.random.default_rng(seed + 34).integers(
        *REPL_KILL_AFTER))
    lis = R.SocketListener()
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--seed", str(seed),
           "--replica-leader", str(root), "--replica-port", str(lis.port),
           "--writer-device", str(device)]
    child = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(x)
                                              for x in child.stdout],
                              daemon=True)
    reader.start()
    try:
        end = lis.accept(timeout=180.0)
        lis.close()
        fol = R.Follower(root / "follower", end, device=device, fsync=True)
        deadline = time.monotonic() + 300
        with tally:
            while fol.counters["applied_records"] < kill_after:
                fol.pump()
                if child.poll() is not None:
                    raise AssertionError(f"the leader child exited "
                                         f"{child.returncode}")
                if time.monotonic() > deadline:
                    raise AssertionError("the follower applied "
                                         f"{fol.counters['applied_records']}"
                                         " records in 300 s")
            child.send_signal(signal.SIGKILL)
            child.wait(timeout=60)
            at_kill = fol.counters["applied_records"]
            for _ in range(4):          # the torn remainder
                fol.pump()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
        reader.join(timeout=60)
        child.stdout.close()
    if child.returncode != -signal.SIGKILL:
        raise AssertionError(f"the leader child exited {child.returncode}")
    acks, failed = [], []
    while not lines.empty():
        word, *nums = lines.get().split()
        (acks if word == "ack" else failed).append(tuple(map(int, nums)))
    t0 = time.perf_counter()
    with tally:
        prom = fol.promote()
    rec = dict(kill_after=kill_after, applied_at_kill=at_kill,
               applied=fol.counters["applied_records"],
               follower=fol.stats(), acked_windows=len(acks),
               failed_windows=len(failed), last_seqno=fol.last_seqno,
               promote_wall_ms=(time.perf_counter() - t0) * 1e3)
    if not acks or failed:
        raise AssertionError(f"replica kill: {len(acks)} windows "
                             f"acknowledged, {len(failed)} failed")
    if max(wm for _, wm in acks) > fol.last_seqno:
        raise AssertionError(f"an acknowledged window (watermark "
                             f"{max(wm for _, wm in acks)}) is not in the "
                             f"promoted log (last seqno {fol.last_seqno})")
    got = write_records(root / "follower" / "wal.log", WAL)
    want = replica_records(seed)
    for j, (g, w) in enumerate(zip(got, want)):
        if not all(np.array_equal(a, b) for a, b in zip(g, w)):
            raise AssertionError(f"replica kill: write record {j} is not "
                                 "the child's stream")
    fresh = SLSM(cascade_params(), device=device)
    oracle = DenseOracle(KEY_BITS)
    for i in range(0, len(got), 64):
        fresh.run_tape([TapeChunk("write", *g) for g in got[i:i + 64]])
    for g in got:
        oracle.apply(*g)
    qs = np.arange(-8, 2 * SCALED_KEYS + 8, dtype=np.int32)
    lo = np.arange(0, 2 * SCALED_KEYS, 2 * SCALED_KEYS // 64, dtype=np.int32)
    wins = np.stack([lo, lo + 256], 1)

    def reads(e):
        return ([e.lookup_many(qs[i:i + LOOKUP_BATCH])
                 for i in range(0, qs.size, LOOKUP_BATCH)]
                + [e.range_many(wins), e.aggregate_many(wins)])

    with tally:
        answers = [reads(prom)]
    answers.append(reads(fresh))
    for j, (g, w) in enumerate(zip(*answers)):
        if not all(np.array_equal(a, b) for a, b in zip(g, w)):
            raise AssertionError(f"replica kill: read {j} of the promoted "
                                 "follower differs from the fresh engine's")
    for i, (v, f) in enumerate(answers[0][:-2]):
        oracle.check_lookups(qs[i * LOOKUP_BATCH:(i + 1) * LOOKUP_BATCH], v,
                             f, "replica kill")
    check_scans(oracle, wins, *answers[0][-2])
    ks = np.array([1, 3, 5], np.int32)
    prom.insert(ks, ks * 7)
    v, f = prom.lookup_many(ks)
    last = WAL.read_wal(root / "follower" / "wal.log")[0][-1]
    if not (f.all() and (v == ks * 7).all() and last.epoch == 1):
        raise AssertionError("the promoted follower does not take writes "
                             "at epoch 1")
    rec.update(write_records=len(got), stream_records=len(want),
               new_epoch=last.epoch, live_keys=int(oracle.present.sum()),
               phase_s=time.perf_counter() - t_phase)
    del prom, fresh, fol
    torch.cuda.empty_cache()
    return rec


# --------------------------------------------------------------------------
# scenarios phase: the paper's workload families and named scenarios
# --------------------------------------------------------------------------

# inserts of an engine run (main: 8M writes): level 0 holds D = 20 runs of
# a flush each (50 seals of 800 keys), so the 20th flush (1,000 seals,
# 800,000 distinct keys) fills it and spills it into disk level 1; 900K
# make 22 flushes (1,124 seals) and keep the whole smoke inside its limit
SCENARIO_N = 900_000
SERVING_N = 50_000              # ops of the 16-client stream (~8,300 requests)
SERVING_ONE_N = 10_000          # ops of the one-client stream (~1,650)
# distinct keys written into the 16-client point's store before its stream:
# 19 flushes leave level 0 one run short of full and 30,000 keys in the
# memory buffer, so the stream's ~31,000 write keys make the 20th flush,
# which spills level 0 into disk level 1 (the stream alone stays in the
# 40,000-key buffer)
SERVING_PRELOAD = 790_000
KV_N = 200_000                  # inserts of each make_kv_workload kind
KV_KINDS = ("normal", "zipf", "cluster-lookup")
SCENARIO_WINDOWS = 64           # derived scan windows of a family without
WINDOW_KEYS = 128               # its own, each spanning this many keys
# but zipfian's: its hot keys sit in every run (up to 1 + R + D = 71 copies
# at these widths), so 128 keys overflow the 512-candidate budget and
# every such scan comes back truncated; 4 keys stay under it
WINDOW_KEYS_OF = {"zipfian": 4}
# (the reference's scenario, an override beyond its own params, inserts):
# each run is the main phase's baseline with the scenario's knob applied.
# The range-scan run widens the candidate budget so no window is
# truncated. zipfian's staging buffer folds each overwrite in place, so a
# memory run fills with 800 distinct keys only after ~2,350 inserts: 2M
# inserts make 17 flushes, short of level 0's 20, and 2.6M make 22.
# Leveling merges a level down once it holds 2 runs, so level 2 (the
# deepest at max_levels 3, ~115 GB at D = 20) would be needed after 4
# flushes: its run keeps max_levels 2, where level 1, the deepest,
# compacts its 2 runs into one of level_cap(1) = 808,960 slots, and
# 750K distinct keys fit that run.
SCENARIO_RUNS = (("sequential", {}, SCENARIO_N),
                 ("zipfian", {}, 2_600_000),
                 ("delete_heavy", {}, SCENARIO_N),
                 ("range_scan", {"range_cand": 16_384}, SCENARIO_N),
                 ("uniform", {}, SCENARIO_N),
                 ("sweep_policy_leveling", {"max_levels": 2}, 750_000),
                 ("sweep_merge_budget_0", {}, SCENARIO_N),
                 ("sweep_eps_0p1", {}, SCENARIO_N),
                 ("sweep_eps_1e-05", {}, SCENARIO_N))


class FinalOracle:
    """The state a workload leaves — its inserts (the last of a key wins),
    then its deletes — as sorted numpy arrays, for reads that all follow
    the writes: a lookup is one binary search, a window two."""

    def __init__(self, keys, vals, deletes):
        uniq, first = np.unique(keys[::-1], return_index=True)
        live = ~np.isin(uniq, deletes)
        self.keys, self.vals = uniq[live], vals[::-1][first][live]

    def lookup(self, qs):
        i = np.minimum(np.searchsorted(self.keys, qs), self.keys.size - 1)
        found = self.keys[i] == qs
        return np.where(found, self.vals[i], 0).astype(np.int32), found

    def check_lookups(self, qs, vals, found, what: str):
        want_v, want_f = self.lookup(qs)
        if not np.array_equal(found, want_f):
            raise AssertionError(f"{what}: found-flags differ on "
                                 f"{int((found != want_f).sum())} keys")
        if not np.array_equal(vals[found], want_v[found]):
            raise AssertionError(f"{what}: values differ from the oracle")

    def window(self, lo, hi):
        a, b = np.searchsorted(self.keys, [lo, hi])
        return self.keys[a:b], self.vals[a:b]


def spanning_windows(keys, rng, n: int = SCENARIO_WINDOWS,
                     per: int = WINDOW_KEYS):
    """`n` [lo, hi) windows from `rng`, each spanning `per` distinct
    `keys` (the scan windows of a family that draws none)."""
    distinct = np.unique(keys)
    i = rng.integers(0, distinct.size - per, n)
    return np.stack([distinct[i], distinct[i + per].astype(np.int64) + 1],
                    axis=1).astype(np.int32)


def measured_fp_rate(eng, absent, max_runs: int = 64):
    """The mean Bloom admit rate of the disk runs' filters on keys absent
    from the store (the reference runner's `measured_fp_rate`: 2,048
    keys, at most 64 runs), probed by the plain PyTorch probe, so no
    counted kernel runs. -> (rate, runs probed, keys probed)."""
    import torch
    from repro_torch.core.bloom import bloom_probe
    p = eng.p_active
    qs = torch.from_numpy(np.ascontiguousarray(absent[:2048], np.int32)).to(
        eng.device)
    admit, runs = 0.0, 0
    for lvl, lv in enumerate(eng.state.levels):
        bits, _, k = p.bloom_geometry(p.level_cap(lvl), p.level_eps(lvl))
        for d in range(min(int(lv.n_runs), max_runs - runs)):
            admit += float(bloom_probe(lv.blooms[d], qs, k, bits).float()
                           .mean())
            runs += 1
    return (admit / runs if runs else 0.0), runs, int(qs.numel())


def absent_keys(oracle, rng, n: int = 4096):
    """Keys the oracle does not hold, drawn from `rng` over int32."""
    qs = rng.integers(-2 ** 31 + 2, 2 ** 31 - 2, 2 * n, dtype=np.int32)
    return qs[~oracle.lookup(qs)[1]][:n]


def scenario_run(eng, keys, vals, deletes, lookups, windows, oracle, total,
                 chunk: int) -> dict:
    """The reference runner's order (`run_scenario`): inserts, then
    deletes, in calls of `chunk` keys, a drain of the merge backlog,
    lookups in batches of LOOKUP_BATCH, then each window as a scan and
    as an aggregate in batches of SCAN_BATCH; every answer against
    `oracle`. Launches counted apart (heap_merge's by shape too) and added
    to `total`."""
    import torch
    from repro_torch.kernels import heap_merge as KHM
    clocks = {k: Clock() for k in ("write", "drain", "lookup", "scan",
                                   "aggregate")}
    merges, n_trunc, n_agg_trunc, most = {}, 0, 0, 0
    tally = total.fresh()
    torch.cuda.reset_peak_memory_stats()
    with tally, merge_tally(merges, KHM.kway_merge):
        for off in range(0, keys.size, chunk):
            with clocks["write"]:
                eng.insert(keys[off:off + chunk], vals[off:off + chunk])
        for off in range(0, deletes.size, chunk):
            with clocks["write"]:
                eng.delete(deletes[off:off + chunk])
        with clocks["drain"]:
            eng.drain()
        for i in range(0, lookups.size, LOOKUP_BATCH):
            qs = lookups[i:i + LOOKUP_BATCH]
            with clocks["lookup"]:
                v, f = eng.lookup_many(qs)
            oracle.check_lookups(qs, v, f, "scenario lookups")
        for i in range(0, len(windows), SCAN_BATCH):
            w = windows[i:i + SCAN_BATCH]
            with clocks["scan"]:
                k, v, c, tr = eng.range_many(w)
            check_scans(oracle, w, k, v, c, tr)
            n_trunc += int(tr.sum())
            most = max(most, int(c.max()))
        for i in range(0, len(windows), SCAN_BATCH):
            w = windows[i:i + SCAN_BATCH]
            with clocks["aggregate"]:
                c, s, tr = eng.aggregate_many(w)
            for j, (a, b) in enumerate(w):
                if tr[j]:
                    n_agg_trunc += 1
                    continue
                ek, ev = oracle.window(int(a), int(b))
                if int(c[j]) != len(ek) or int(s[j]) != wrap_sum(ev):
                    raise AssertionError(f"aggregate {a}:{b} differs")
    total.add(tally)
    t = {k: c.total for k, c in clocks.items()}
    return dict(
        inserts=int(keys.size), deletes=int(deletes.size),
        write_ops_per_s=(keys.size + deletes.size) / t["write"],
        drain_s=t["drain"], lookups=int(lookups.size),
        lookups_per_s=lookups.size / t["lookup"], scans=len(windows),
        scans_per_s=len(windows) / t["scan"],
        aggregates_per_s=len(windows) / t["aggregate"],
        scans_truncated=n_trunc, aggregates_truncated=n_agg_trunc,
        keys_returned_max=most, n_levels=eng.n_levels,
        level_runs=[int(lv.n_runs) for lv in eng.state.levels],
        stats={k: int(eng.stats[k]) for k in
               ("seals", "flushes", "spills", "compactions", "backlog_peak",
                "rows_annihilated")},
        launches=dict(tally.counts), rounds=dict(tally.rounds),
        heap_merge_by_shape=merges,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        live_keys=int(oracle.keys.size))


def free_engine(eng) -> None:
    """Drop an engine's device memory before the next run starts: the
    engine's scheduler and tuner refer back to it, so only a collection
    frees it."""
    import gc

    import torch
    eng.state = None
    gc.collect()
    torch.cuda.empty_cache()


def check_launched(what: str, rec: dict, need) -> None:
    """Every kernel of `need` launched, no round kernel."""
    missing = [k for k in need if rec["launches"][k] == 0]
    if missing or any(rec["rounds"].values()):
        raise AssertionError(f"{what}: never launched {missing}, rounds "
                             f"{rec['rounds']}")


ENGINE_KERNELS = ("bloom_probe", "fence_lookup", "heap_merge", "range_merge")


class DispatchFront:
    """`closed_loop`'s server: submits to `srv` and, after each pump,
    holds every reply of the window against `oracle` in submission order,
    which is the server's dispatch order: writes into the oracle, reads
    against it."""

    def __init__(self, srv, oracle):
        self.srv, self.oracle, self.new = srv, oracle, []

    @property
    def counters(self):
        return self.srv.counters

    def submit(self, client, kind, keys, vals=None):
        t = self.srv.submit(client, kind, keys, vals)
        self.new.append(t)
        return t

    def pump(self, force: bool = False) -> int:
        n = self.srv.pump(force=force)
        for t in self.new:
            if not t.done:
                raise AssertionError("a forced pump left a request unserved")
            if t.kind == "insert":
                self.oracle.insert(t.keys, t.vals)
            elif t.kind == "delete":
                self.oracle.delete(t.keys)
            elif t.kind == "lookup":
                self.oracle.check_lookups(t.keys, *t.result, "serving reply")
            else:
                check_scans(self.oracle, np.stack([t.keys, t.vals], 1),
                            *t.result)
        self.new = []
        return n


def serving_run(device, seed: int, total) -> list:
    """`make_serving` (its defaults) through `Server` and `closed_loop`, a
    fresh engine at the main phase's baseline a point: SERVING_ONE_N ops
    at one client on an empty store, then SERVING_N ops at 16 clients on
    a store that already holds SERVING_PRELOAD distinct keys of the
    stream's key space (written before the stream, uncounted), whose
    writes spill into disk level 1. Every reply against the oracle at its
    point in the dispatch order (stream order at one client). Launches
    counted a point, and added to `total`."""
    import torch
    from repro_torch.bench.workloads import make_serving
    from repro_torch.configs.slsm_paper import paper_params
    from repro_torch.engine import SLSM
    from repro_torch.serve import Server, closed_loop

    out = []
    for clients, n_ops, preload in ((1, SERVING_ONE_N, 0),
                                    (16, SERVING_N, SERVING_PRELOAD)):
        w = make_serving(n_ops, seed)
        bits = int(np.log2(w.meta["key_space"]))
        eng = SLSM(paper_params(merge_budget=1, range_cand=512),
                   device=device)
        oracle = DenseOracle(bits)
        if preload:
            rng = np.random.default_rng(seed + 43)
            keys = (rng.choice(2 ** (bits - 1), preload, replace=False)
                    * 2).astype(np.int32)
            vals = rng.integers(1, 2 ** 30, preload, dtype=np.int32)
            for off in range(0, preload, 100_000):
                eng.insert(keys[off:off + 100_000], vals[off:off + 100_000])
            oracle.insert(keys, vals)
        srv = Server(eng)
        srv.warm()
        front, tally = DispatchFront(srv, oracle), total.fresh()
        before = {k: int(eng.stats[k]) for k in ("seals", "flushes",
                                                 "spills")}
        torch.cuda.reset_peak_memory_stats()
        with tally:
            loop = closed_loop(front, w.requests, clients)
            srv.drain()
        total.add(tally)
        rec = dict(clients=clients, requests=len(w.requests), ops=w.n,
                   preloaded_keys=preload,
                   **{k: loop[k] for k in ("ops_per_s", "requests_per_s",
                                           "p50_us", "p99_us", "windows",
                                           "dispatches")},
                   n_levels=eng.n_levels,
                   level_runs=[int(lv.n_runs) for lv in eng.state.levels],
                   stats={k: int(eng.stats[k]) - before[k] for k in before},
                   launches=dict(tally.counts), rounds=dict(tally.rounds),
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   live_keys=int(front.oracle.present.sum()))
        # the kernels this state's structures call for: range_merge for
        # the scans; a flushed memory buffer adds heap_merge, a disk run
        # bloom_probe and fence_lookup; the preloaded point must flush,
        # spill into disk level 1 and launch all four
        need = ["range_merge"]
        if rec["stats"]["flushes"]:
            need.append("heap_merge")
        if eng.n_levels:
            need += ["bloom_probe", "fence_lookup"]
        if preload and (rec["stats"]["spills"] == 0
                        or set(need) != set(ENGINE_KERNELS)):
            raise AssertionError(f"serving at {clients} clients: the "
                                 f"stream never spilled into disk level 1 "
                                 f"({rec['stats']}, {rec['level_runs']})")
        check_launched(f"serving at {clients} clients", rec, need)
        out.append(rec)
        del srv
        free_engine(eng)
    return out


LEVELING_ITERS = 4      # calls a time of the 323,584,000-lane compaction


def scenario_kernel_cases(name: str, eng, rec: dict, lookups, rng) -> list:
    """The kernel shapes a scenario run adds to the table, timed on the
    card as the kernels phase times its own: bloom_probe over the run's
    own filters (its eps's k) and a lookup batch of its keys, for the
    eps sweeps; heap_merge at leveling's two new shapes: the 2-run spill
    of level 0 (synthetic sorted runs) and the deepest level's
    compaction over all D slots (the run's own final level, in place).
    -> (kernel name, case record) pairs."""
    import torch
    out = []
    if name.startswith("sweep_eps"):
        p = eng.p_active
        stacks = []
        for level, lv in enumerate(eng.state.levels):
            bits, _, k = p.bloom_geometry(p.level_cap(level),
                                          p.level_eps(level))
            stacks.append((lv.blooms, k, bits))
        qs = torch.from_numpy(np.ascontiguousarray(
            lookups[:LOOKUP_BATCH], np.int32)).to(eng.device)
        out.append(("bloom_probe", bloom_case(
            f"scenarios: {name}, its filters", stacks, qs, None)))
    if name == "sweep_policy_leveling":
        # the spill of level 0's two runs, and the deepest level's
        # compaction over all D slots, read in place from the final state
        # (its runs as the run left them)
        p = eng.p
        out.append(("heap_merge", merge_case(
            f"scenarios: leveling spill, 2 x {p.level_cap(0)}", 2,
            p.level_cap(0), p.runs_merged * p.Rn, rng, eng.device)))
        lv = eng.state.levels[-1]
        out.append(("heap_merge", merge_case(
            f"scenarios: leveling compaction, {int(lv.n_runs)} of "
            f"{p.D} runs filled", p.D, lv.keys.shape[1], 0, rng,
            eng.device, [a.reshape(-1) for a in (lv.keys, lv.wts,
                                                 lv.seqs)],
            iters=LEVELING_ITERS)))
    return out


def scenarios_phase(device, seed: int, total, card: str) -> dict:
    """The paper's workload families (`repro_torch.bench.workloads`)
    through the engine at the paper's widths, one fresh engine a run (see
    the module docstring): each run of SCENARIO_RUNS is the main phase's
    baseline with its scenario's knob, then the serving stream, then
    three `make_kv_workload` kinds at the KV service example's geometry.
    Every answer exact; every engine kernel launched; no round kernel.
    Each run's launches are counted apart and added to `total`. Logs a
    line a run; -> the phase's records and its kernel cases
    (`scenario_kernel_cases`)."""
    import torch
    from repro_torch.bench.scenarios import SCENARIOS
    from repro_torch.bench.workloads import make_kv_workload, make_workload
    from repro_torch.configs.slsm_paper import paper_params
    from repro_torch.engine import SLSM, LevelingPolicy, TieringPolicy

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 41)
    runs, cases = [], []
    for i, (name, extra, n_inserts) in enumerate(SCENARIO_RUNS, 1):
        sc = SCENARIOS[name]
        t0 = time.perf_counter()
        p = paper_params(**{"merge_budget": 1, "range_cand": 512,
                            **sc.params, **extra})
        policy = {"tiering": TieringPolicy,
                  "leveling": LevelingPolicy}[sc.policy]()
        w = make_workload(sc.workload, n_inserts, seed, **sc.wargs)
        windows = (w.ranges if len(w.ranges) else spanning_windows(
            w.keys, rng, per=WINDOW_KEYS_OF.get(sc.workload, WINDOW_KEYS)))
        oracle = FinalOracle(w.keys, w.vals, w.deletes)
        eng = SLSM(p, policy=policy, device=device)
        eng.warm()
        setup_s = time.perf_counter() - t0
        rec = dict(run=i, scenario=name, workload=w.name, setup_s=setup_s,
                   params=dict(R=p.R, Rn=p.Rn, D=p.D, mu=p.mu, eps=p.eps,
                               max_levels=p.max_levels,
                               max_range=p.max_range,
                               range_cand=p.range_cand,
                               merge_budget=p.merge_budget,
                               policy=sc.policy),
                   **scenario_run(eng, w.keys, w.vals, w.deletes, w.lookups,
                                  windows, oracle, total, 4 * p.Rn))
        fp, n_runs, n_keys = measured_fp_rate(eng, w.absent)
        rec.update(fp_rate_measured=fp, fp_runs_probed=n_runs,
                   fp_keys_probed=n_keys, eps_configured=p.eps)
        cases.extend(scenario_kernel_cases(name, eng, rec, w.lookups, rng))
        if sc.workload == "delete-heavy":
            dead = np.isin(w.lookups, w.deletes)
            rec["lookups_on_deleted_keys"] = int(dead.sum())
            if not dead.any():
                raise AssertionError("delete_heavy: no lookup of a "
                                     "deleted key")
        free_engine(eng)
        rec["run_s"] = time.perf_counter() - t0
        log(f"scenarios run {i} {name} [{card}]: " + json.dumps(rec))
        check_launched(f"scenario {name}", rec, ENGINE_KERNELS)
        if rec["n_levels"] < 2 or rec["level_runs"][1] + rec["stats"][
                "spills"] == 0:
            raise AssertionError(f"scenario {name}: disk level 1 never "
                                 f"reached ({rec['level_runs']})")
        if sc.policy == "leveling" and max(rec["level_runs"]) > 2:
            raise AssertionError(f"scenario {name}: more than 2 runs a "
                                 f"level ({rec['level_runs']})")
        if sc.workload == "range-scan" and (rec["scans_truncated"]
                                            or rec["aggregates_truncated"]):
            raise AssertionError(f"scenario {name}: truncated windows")
        runs.append(rec)

    t0 = time.perf_counter()
    serving = serving_run(device, seed, total)
    for rec in serving:
        log(f"scenarios run {len(runs) + 1} serving [{card}]: "
            + json.dumps(rec))
    runs.append(dict(run=len(runs) + 1, scenario="serving", points=serving,
                     run_s=time.perf_counter() - t0))

    p = paper_params(R=8, Rn=512, D=4, mu=64, max_levels=4, max_range=4096)
    for kind in KV_KINDS:
        t0 = time.perf_counter()
        w = make_kv_workload(kind, KV_N, seed)
        oracle = FinalOracle(w.keys, w.vals, np.zeros(0, np.int32))
        eng = SLSM(p, device=device)
        eng.warm()
        rec = dict(run=len(SCENARIO_RUNS) + 2, scenario=f"kv {kind}",
                   workload=w.name, negative_keys=int((w.keys < 0).sum()),
                   **scenario_run(eng, w.keys, w.vals, np.zeros(0, np.int32),
                                  w.lookups, spanning_windows(w.keys, rng),
                                  oracle, total, 4 * p.Rn))
        fp, n_runs, n_keys = measured_fp_rate(eng, absent_keys(oracle, rng))
        rec.update(fp_rate_measured=fp, fp_runs_probed=n_runs,
                   fp_keys_probed=n_keys, eps_configured=p.eps)
        free_engine(eng)
        rec["run_s"] = time.perf_counter() - t0
        log(f"scenarios run {rec['run']} kv {kind} [{card}]: "
            + json.dumps(rec))
        check_launched(f"kv {kind}", rec, ENGINE_KERNELS)
        runs.append(rec)
    return dict(runs=runs, cases=cases, phase_s=time.perf_counter() - t_phase)


# --------------------------------------------------------------------------
# LM phases: decode over the sLSM-tiered KV cache, Phi-4-mini at full width
# --------------------------------------------------------------------------

# the kernel against its plain version: both sum in f32 (in another
# order) and round once to the output dtype, so bf16 may differ by one
# ulp (2**-7 relative) plus f32 noise, here a thousandth of the largest
# output; f32 by its summation noise alone
ATT_TOL = {"bfloat16": dict(atol_of_max=1e-3, rtol=8e-3),
           "float32": dict(atol=1e-5, rtol=1e-4)}


def att_within(got, want, dtype: str) -> bool:
    import torch
    tol = dict(ATT_TOL[dtype])
    want = want.float()
    if "atol_of_max" in tol:
        tol["atol"] = tol.pop("atol_of_max") * float(want.abs().max())
    return torch.allclose(got.float(), want, **tol)


def lm_config():
    from repro_torch.configs import get_config
    return get_config(LM_ARCH)


def att_close(got, want, dtype: str) -> float:
    """Max abs error of the kernel against its plain version; raises
    beyond the stated tolerance."""
    err = float((got.float() - want.float()).abs().max())
    if not att_within(got, want, dtype):
        raise AssertionError(f"lsm_attention differs from its plain version "
                             f"({dtype}): max abs err {err}")
    return err


def tiered_case(device, gen, dt, w, mu, topk, kv, dh, b, h):
    """A serve-shaped tiered cache: 23 sealed blocks (the block axis
    padded to 32), hot_len 1,056 and 2,119, row 1 missing half its
    selected blocks for half its kv heads. Every row the kernel must not
    read is NaN: hot rows at or past hot_len, and each (block, kv head)
    that is not a selected `ok` block."""
    import torch
    from repro_torch.kernels.lsm_attention import ops as KLA
    nb, n_blocks = 32, (SERVE_PROMPT - 1) // mu

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dt)

    q, hk, hv = rnd(b, h, dh), rnd(b, w, kv, dh), rnd(b, w, kv, dh)
    bk, bv = rnd(b, nb, mu, kv, dh), rnd(b, nb, mu, kv, dh)
    summ = bk.float().mean(dim=2).to(dt)
    hot_len = torch.tensor([SERVE_HOT, 2 * SERVE_HOT + 7], dtype=torch.int32,
                           device=device)
    ids, ok = KLA.select_blocks(q, summ, torch.full((b,), n_blocks,
                                                    device=device), topk)
    ok[1, :kv // 2, 12:] = False
    read = torch.zeros(b, nb, kv, dtype=torch.bool, device=device)
    read[torch.arange(b, device=device)[:, None, None], ids,
         torch.arange(kv, device=device)[None, :, None]] = ok
    gone = ~read[:, :, None, :, None].expand_as(bk)
    for t in (bk, bv):
        t[gone] = float("nan")
    for r in range(b):
        for t in (hk, hv):
            t[r, int(hot_len[r]):] = float("nan")
    n_valid = int(hot_len.sum()) * kv + int(ok.sum()) * mu
    return (q, hk, hv, hot_len, bk, bv, ids, ok), n_valid


LSM_CASES = (("tiered", "bfloat16"), ("dense", "bfloat16"),
             ("bitmap", "bfloat16"), ("tiered", "float32"))


def lsm_kernel_phase(device, seed: int):
    """The attention kernel against its plain version at the LM path's
    shapes — the tiered cache read in place (bf16, and once in f32), the
    dense cache of the agreement phase by lengths, and the Pallas
    contract (K/V and a bitmap) on the gathered tiered input — each with
    its planted faults; device times of kernel, plain version,
    `F.scaled_dot_product_attention` on the (gathered) K/V and, for the
    tiered cases, the path it replaces (gather, concatenate, bitmap,
    kernel)."""
    cases = lsm_kernel_cases(device, seed, lm_config(), LSM_CASES)
    main = dict(cases[0])
    main.update(name="lsm_attention", route="cuda",
                source="src/repro_torch/csrc/lsm_attention.cu",
                replaces="src/repro/kernels/lsm_attention/lsm_attention.py:36",
                cases=cases[1:])
    return main


def moe_kernel_phase(device, seed: int) -> list:
    """`moe_kernel`: the attention kernel at the two moe decode shapes
    (head dim 64; Granite's query group of 2 in one pass, Qwen3's group
    of 8 in two passes of 4 heads), the tiered bf16 case of
    `lsm_kernel_phase` with its planted faults and tolerance."""
    from repro_torch.configs import get_config
    recs = []
    for arch in (MOE_SERVE_ARCH, MOE_AGREE_ARCH):
        for rec in lsm_kernel_cases(device, seed, get_config(arch),
                                    (("tiered", "bfloat16"),)):
            rec["case"] = f"moe {arch}: {rec['case']}"
            recs.append(rec)
    return recs


def lsm_kernel_cases(device, seed: int, cfg, which, dense=None) -> list:
    """One record a (case, dtype) of `which` at `cfg`'s decode shapes
    (batch 2); see `lsm_kernel_phase`. `dense` = (L, (length of row 0,
    of row 1)) sets the dense case's cache, by default lm_agree's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.lsm_attention import ops as KLA
    from repro_torch.launch import cost

    b, h, kv, dh = 2, cfg.n_heads, cfg.n_kv, cfg.hd
    w, mu, topk = cfg.lsm_hot_window, cfg.lsm_block, cfg.lsm_topk
    gen = torch.Generator(device).manual_seed(seed + 5)
    scale = dh ** -0.5
    cases = []
    for name, dtype in which:
        dt = getattr(torch, dtype)
        faults = {}
        if name == "dense":
            length, lens = dense or (AGREE_PROMPT + 2 * AGREE_STEPS,
                                     (AGREE_PROMPT + 1, AGREE_PROMPT + 5))
            q, k, v = (torch.randn(s, generator=gen, device=device).to(dt)
                       for s in ((b, h, dh), (b, length, kv, dh),
                                 (b, length, kv, dh)))
            lens = torch.tensor(lens, dtype=torch.int32, device=device)
            for r in range(b):
                k[r, int(lens[r]):] = float("nan")
                v[r, int(lens[r]):] = float("nan")
            valid = (torch.arange(length, device=device)[None, :]
                     < lens[:, None])[:, None, :].expand(b, kv, -1)
            valid = valid.to(torch.int8).contiguous()
            n_valid = int(valid.sum())
            shape = (f"q ({b}, {h}, {dh}); k, v ({b}, {length}, {kv}, {dh}); "
                     f"lengths {lens.tolist()}")

            def kernel():
                return KLA.decode_attention_op(q, k, v, lens, scale)

            def plain():
                return KLA.decode_attention_plain(q, k, v, valid, scale)
            mode = dict(mode="lengths")
            ks, vs = k, v
        else:
            args, n_valid = tiered_case(device, gen, dt, w, mu, topk, kv,
                                        dh, b, h)
            q, hot_len, ids, ok = args[0], args[3], args[6], args[7]
            k, v, valid = KLA.tiered_inputs(*args[1:8])
            ks, vs = k, v
            length = k.shape[1]
            shape = (f"q ({b}, {h}, {dh}); hot ({b}, {w}, {kv}, {dh}), "
                     f"hot_len {hot_len.tolist()}; blocks ({b}, "
                     f"{args[4].shape[1]}, {mu}, {kv}, {dh}), top {topk}")

            def plain():
                return KLA.lsm_decode_attention_plain(*args, scale)
            if name == "tiered":
                def kernel():
                    return KLA.lsm_decode_attention(*args, scale)
                mode = dict(mode="tiered", topk=ids.shape[-1])

                def block_off():
                    ok2 = ok.clone()
                    ok2[:, :, 0] = False
                    return KLA.lsm_decode_attention(*args[:7], ok2, scale)
                faults["top_block_not_ok"] = block_off
            else:
                shape = (f"q ({b}, {h}, {dh}); gathered k, v ({b}, {length}"
                         f", {kv}, {dh}) and bitmap")

                def kernel():
                    return KLA.decode_attention(q, k, v, valid, scale)
                mode = dict(mode="bitmap", length=length)
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"lsm_kernel {name} {dtype}: the kernel "
                                 "read a row it must not (non-finite out)")
        err = att_close(got, want, dtype)
        # controls: a planted fault must fail the same check, or the
        # tolerance could not see a wrong kernel — the plain version with
        # every 32nd position dropped against the kernel's output, and
        # each kernel-side fault against the plain version
        skipped = valid.clone()
        skipped[..., ::32] = 0
        pairs = {"skip_every_32nd": (got, KLA.decode_attention_plain(
            q, ks, vs, skipped, scale))}
        pairs.update((fault, (fn(), want)) for fault, fn in faults.items())
        fault_err = {}
        for fault, (bad, ref) in pairs.items():
            if att_within(bad, ref, dtype):
                raise AssertionError(f"lsm_kernel {name} {dtype}: fault "
                                     f"{fault} passes the tolerance")
            fault_err[fault] = float((bad.float() - ref.float()).abs().max())
        del skipped, pairs
        out_abs = want.float().abs()
        # work: q and out once, K and V once for each valid (b, kv, l)
        # row (the kernel never reads another), what locates the rows
        n_ops, n_bytes = cost.kernel_cost(
            "lsm_attention", b=b, h=h, kv=kv, dh=dh, rows=n_valid,
            elt=q.element_size(), **mode)
        # SDPA yardstick on the (gathered) K/V: heads-major K/V and a
        # per-q-head boolean mask, made outside the timed call
        kh, vh = (t.transpose(1, 2).contiguous() for t in (ks, vs))
        mask = valid.bool().repeat_interleave(h // kv, dim=1)[:, :, None, :]
        q4 = q[:, :, None, :]
        rec = dict(
            case=f"{name} {dtype}", shape=shape, valid_rows=n_valid,
            max_abs_err=err, mean_abs_out=float(out_abs.mean()),
            max_abs_out=float(out_abs.max()), tol=ATT_TOL[dtype],
            fault_max_abs_err=fault_err,
            ms=device_ms(kernel, 20), wall_ms=wall_ms(kernel, 20),
            plain_ms=device_ms(plain, 5),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                q4, kh, vh, attn_mask=mask, enable_gqa=True), 20),
            bytes_bound_ms=cost.bound_ms(0, n_bytes)[0],
            ops_bound_ms=cost.bound_ms(n_ops, 0)[0])
        if name == "tiered":
            def replaced():
                kk, vv, val = KLA.tiered_inputs(*args[1:8])
                return KLA.decode_attention(q, kk, vv, val, scale)
            rec["replaced_ms"] = device_ms(replaced, 20)
            rec["replaced_wall_ms"] = wall_ms(replaced, 20)
        rec["bound_ms"], rec["bound_by"] = cost.bound_ms(n_ops, n_bytes)
        log(f"lsm_kernel {json.dumps(rec)}")
        cases.append(rec)
        del q, k, v, ks, vs, kh, vh, valid, mask, got, want
        if name != "dense":
            del args
        torch.cuda.empty_cache()
    return cases


def prompt_batch(cfg, tokens) -> dict:
    """A text prompt's batch: with M-RoPE, its three position streams,
    all equal to the token's index (3, B, S)."""
    import torch
    batch = {"tokens": tokens}
    if cfg.mrope:
        b, s = tokens.shape
        batch["positions3"] = torch.arange(s).expand(3, b, s)
    return batch


def lm_serve_phase(device, seed: int, counters: dict, cfg=None):
    """`generate(kind="lsm")` at full width (Phi-4-mini unless `cfg` is
    given): 2 requests x 24,576-token prompts, 32 new tokens; the kernel
    once per attention (a layer, or an application of the hybrid's
    shared block) per step. The counters are set to 0 just before
    `generate` and read just after."""
    import torch
    from repro_torch.kernels.lsm_attention import ops as KLA
    from repro_torch.models import lm
    from repro_torch.serving import generate

    cfg = cfg or lm_config()
    t0 = time.perf_counter()
    model = lm.init_params(cfg, seed, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(seed + 6)
    prompt = torch.randint(0, cfg.vocab, (2, SERVE_PROMPT), generator=gen)
    for fn in (*counters.values(), KLA.lsm_decode_attention):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    toks, caches = generate(cfg, model, prompt_batch(cfg, prompt),
                            SERVE_STEPS, "lsm", stats=stats)
    launches = {k: fn.launches for k, fn in counters.items()}
    tiered = KLA.lsm_decode_attention.launches
    peak = torch.cuda.max_memory_allocated()
    n_steps = SERVE_STEPS - 1
    want = lm.n_attention(cfg) * n_steps
    if launches["lsm_attention"] != want or tiered != want:
        raise AssertionError(f"lsm_attention launched "
                             f"{launches['lsm_attention']} times, "
                             f"{tiered} of them in place on the tiered "
                             f"cache; expected {want} of each (one per "
                             f"attention per step)")
    if not stats["finite"]:
        raise AssertionError(f"{cfg.name} serve: a logit was not finite")
    stack = lm.kv_stack(cfg, caches)
    n_blk = stack["n_blocks"].unique().tolist()
    hot = stack["hot_len"].unique().tolist()
    want_blk = (SERVE_PROMPT - 1) // cfg.lsm_block
    want_hot = SERVE_PROMPT - want_blk * cfg.lsm_block + n_steps
    if n_blk != [want_blk] or hot != [want_hot]:
        raise AssertionError(f"{cfg.name} serve: n_blocks {n_blk} hot_len "
                             f"{hot}, expected {want_blk} and {want_hot}")
    if toks.shape != (2, SERVE_STEPS) or not (
            (toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"{cfg.name} serve: bad tokens "
                             f"{tuple(toks.shape)}")
    rec = dict(
        arch=cfg.name, dtype=cfg.dtype, batch=2, prompt=SERVE_PROMPT,
        new_tokens=SERVE_STEPS, init_s=init_s, prefill_s=stats["prefill_s"],
        decode_ms_per_step=stats["decode_s"] / n_steps * 1e3,
        decode_tokens_per_s=2 * n_steps / stats["decode_s"],
        n_blocks=want_blk, hot_len=want_hot, seals=stats["seals"],
        max_memory_allocated=peak, launches=launches,
        tiered_in_place_launches=tiered)
    rec.update(decode_window(cfg, model, caches, toks[:, -1]))
    return model, caches, rec


def decode_window(cfg, model, caches, tok, n: int = 4):
    """Device-busy share of `n` decode steps: host time unprofiled, then
    the device time torch.profiler traces over the same number. No
    `torch.gather` kernel may run in the window: the attention reads the
    cold blocks in place (the only concatenation left is RoPE's, and a
    Mamba-2 layer's rolling conv history; recorded as
    `window_cat_ms`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm

    clock = Clock()
    with clock:
        for _ in range(n):
            logits, caches2 = lm.decode_step(cfg, model, tok, caches, "lsm")
            caches.update(caches2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            logits, caches2 = lm.decode_step(cfg, model, tok, caches, "lsm")
            caches.update(caches2)
        torch.cuda.synchronize()
    by_name = device_us_by_name(prof)
    gathers = [k for k in by_name if "scatter_gather" in k]
    if gathers:
        raise AssertionError(f"decode window ran torch.gather: {gathers}")
    busy_ms = sum(by_name.values()) / 1e3
    wall = clock.total * 1e3
    return dict(window_steps=n, window_wall_ms=wall,
                window_device_ms=busy_ms,
                window_cat_ms=sum(us for k, us in by_name.items()
                                  if "CatArray" in k) / 1e3,
                device_busy_share=busy_ms / wall if busy_ms else
                "not measured",
                window_top=[(k[:48], round(us / 1e3, 4))
                            for k, us in by_name.most_common(6)])


def lm_seal_phase(cfg, model, caches, seed: int):
    """Fill the hot window of every slot of the stacked KV cache (each
    layer's, or each application's of the hybrid's shared block) with
    seeded K/V, seal, check the new block and its summary, then decode
    one step and hold the first attention's kernel output against the
    plain version."""
    import torch
    from repro_torch.kernels.lsm_attention import ops as KLA
    from repro_torch.models import lm
    from repro_torch.serving import seal_hot_block

    w, mu = cfg.lsm_hot_window, cfg.lsm_block
    stack = lm.kv_stack(cfg, caches)
    hl = int(stack["hot_len"][0, 0])
    gen = torch.Generator(stack["hot_k"].device).manual_seed(seed + 7)
    for key in ("hot_k", "hot_v"):
        t = stack[key]
        t[:, :, hl:] = torch.randn(t[:, :, hl:].shape, generator=gen,
                                   device=t.device).to(t.dtype)
    stack["hot_len"].fill_(w)
    old_k = stack["hot_k"][:, :, :mu].clone()
    old_v = stack["hot_v"][:, :, :mu].clone()
    n0 = stack["n_blocks"].clone()
    caches = seal_hot_block(cfg, caches)
    stack = lm.kv_stack(cfg, caches)
    li = torch.arange(n0.shape[0], device=n0.device)[:, None]
    bi = torch.arange(n0.shape[1], device=n0.device)[None, :]
    slot = n0.long()
    if not (torch.equal(stack["blk_k"][li, bi, slot], old_k)
            and torch.equal(stack["blk_v"][li, bi, slot], old_v)):
        raise AssertionError("lm_seal: the new block is not the old hot[:mu]")
    # the summary: an f32 mean rounded once to bf16, as the kernel's output
    summ = stack["summ"][li, bi, slot]
    if not att_within(summ, old_k.float().mean(dim=2), cfg.dtype):
        raise AssertionError("lm_seal: summary is not the block's mean")
    if not (torch.equal(stack["n_blocks"], n0 + 1)
            and bool((stack["hot_len"] == w - mu).all())):
        raise AssertionError("lm_seal: counters did not move")
    seen = []
    kernel = KLA.lsm_decode_attention

    def first_call(*args):
        """Layer 0's call: put the entry point back, run it, keep its
        inputs and output."""
        KLA.lsm_decode_attention = kernel
        out = kernel(*args)
        seen.append((args, out))
        return out

    KLA.lsm_decode_attention = first_call
    try:
        logits, caches = lm.decode_step(cfg, model, torch.zeros(
            2, dtype=torch.int64, device=n0.device), caches, "lsm")
    finally:
        KLA.lsm_decode_attention = kernel
    args, out = seen[0]
    err = att_close(out, KLA.lsm_decode_attention_plain(*args), cfg.dtype)
    hot_len, ok = args[3], args[7]
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("lm_seal: a logit after the seal is not finite")
    stack = lm.kv_stack(cfg, caches)
    return dict(arch=cfg.name, n_blocks=int(stack["n_blocks"][0, 0]),
                hot_len=int(stack["hot_len"][0, 0]),
                layer0_kernel_max_abs_err=err,
                layer0_valid_positions=int(hot_len.sum()) * cfg.n_kv
                + int(ok.sum()) * mu)


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def fork(caches: dict, everything: bool = False) -> dict:
    """Caches for a side step: the recurrent state (the ssm and hybrid
    families' `ssm` and `conv`, which a decode step advances in place)
    copied, the KV cache shared (a side step writes only the hot slot or
    position the real step then overwrites); with `everything`, a deep
    copy."""
    out = {}
    for k, t in caches.items():
        if isinstance(t, dict):
            out[k] = fork(t, everything) if everything else t
        else:
            out[k] = t.clone() if everything or k in ("ssm", "conv") else t
    return out


class expert_picks:
    """Each moe layer's choice of experts, in call order. Under
    `record()` the router's picks are kept; under `replay()` the next
    router calls, in the same order, take the kept picks: each still
    computes its own probabilities and weights the experts by them, only
    which experts run is the recorded choice."""

    def __init__(self):
        self.picks = []

    @contextlib.contextmanager
    def _patched(self, replay: bool):
        from repro_torch.models import moe as MOE
        real = MOE._route
        kept = iter(list(self.picks))
        if not replay:
            self.picks = []

        def route(cfg, p, xt):
            probs, top_p, top_e = real(cfg, p, xt)
            if replay:
                top_e = next(kept, None)
                if top_e is None:
                    raise AssertionError("expert_picks: more router calls "
                                         "than recorded")
                return probs, probs.gather(-1, top_e), top_e
            self.picks.append(top_e)
            return probs, top_p, top_e

        MOE._route = route
        try:
            yield self
        finally:
            MOE._route = real
        if replay and next(kept, None) is not None:
            raise AssertionError("expert_picks: fewer router calls than "
                                 "recorded")

    def record(self):
        return self._patched(False)

    def replay(self):
        return self._patched(True)

    def differ(self, other) -> int:
        """(layer, token) pairs whose expert sets differ from other's."""
        return sum(int((a.sort(-1).values != b.sort(-1).values).any(-1)
                       .sum()) for a, b in zip(self.picks, other.picks))


def plain_dense(q, k, v, lengths, scale):
    """The dense entry point's plain version (`decode_attention_op`'s
    arguments), on the card."""
    import torch
    from repro_torch.kernels.lsm_attention import ops as KLA
    valid = (torch.arange(k.shape[1], device=k.device)[None, :]
             < lengths[:, None])[:, None, :].expand(
                 k.shape[0], k.shape[2], -1).to(torch.int8)
    return KLA.decode_attention_plain(q, k, v, valid.contiguous(), scale)


def lm_agree_phase(cfg, model, seed: int):
    """2 x 8,192-token prompts: n_blocks = 7 <= topk, so every cold block
    is selected and the tiered decode must equal the dense one. 8 steps,
    teacher-forced by the dense tokens, both through the kernel; the
    kernel's launches of those steps (not the control's) are returned
    as `launches`.

    Through 32 bf16 layers any change of summation order moves the
    logits by nearly as much as the 2e-2 limit allows, so the sharp
    check is "layer 0", the first attention call: its input (the
    token's embedding, or for the hybrid the same ssm blocks' output
    from the same state) and its K/V are the same in both layouts, and
    its kernel outputs must agree to the kernel tolerance. A control
    step with the top-scoring selected block masked out in every layer
    must fail that check. Side steps run on `fork`s of the caches, so a
    hybrid's ssm state advances once a step. A hybrid's Mamba-2 blocks
    keep each step's ulp of attention difference in their state, so in
    bf16 its logits limit at a step is 2e-2 or FLOOR_X times that step's
    dense floor (the plain-attention dense step against the kernel's),
    if that is more; that limit does not see a masked block, whose
    logits move by about as much. In f32 (a model's f32 copy) the limit
    is F32_LIMIT at every step, and the control's logits must exceed
    it.

    A moe model's router picks its top k experts, a choice that one
    bf16 ulp of difference in a layer's input can flip between two
    near-equal experts, and each flip moves that token's hidden state
    by a step, not by an ulp's drift. So for a moe model the tiered step
    (and the control, and the noise floor's step) runs the experts the
    dense step's router picked, layer by layer (`expert_picks`): the
    2e-2 limit then holds the two cache layouts and kernel calls against
    each other, not the flips they share. The tiered step with its own
    routing runs too, on the same cache before the forced one, beside
    an own-routing floor: the dense step with the plain version's
    attention and its own routing, whose flips come from summation
    order alone. The own-routing tiered rel L2 must stay within
    FLOOR_X times the largest floor over the steps (or 2e-2, if that is
    more), so a fault that acts through the routing still fails;
    the number of (layer, token) expert sets that differ is recorded. A
    moe record adds `decode_window` of the tiered cache after the last
    step."""
    import torch
    from repro_torch.kernels.lsm_attention import ops as KLA
    from repro_torch.models import lm
    from repro_torch.serving import grow_dense, lsm_from_dense

    gen = torch.Generator().manual_seed(seed + 8)
    prompt = torch.randint(0, cfg.vocab, (2, AGREE_PROMPT), generator=gen)
    logits, dense = lm.prefill_step(cfg, model, prompt_batch(cfg, prompt))
    max_len = AGREE_PROMPT + 2 * AGREE_STEPS
    tiered = lsm_from_dense(cfg, dense, max_len)
    dense = grow_dense(cfg, dense, max_len)
    n_blk = int(lm.kv_stack(cfg, tiered)["n_blocks"][0, 0])
    if n_blk > cfg.lsm_topk:
        raise AssertionError(f"lm_agree: {n_blk} blocks > topk")
    floor = fork(dense, everything=True)
    kernel = KLA.decode_attention        # carries the launch count
    entry = {"dense": "decode_attention_op", "lsm": "lsm_decode_attention"}

    def step(caches, kind, plain=False, drop_block=False):
        """One decode step, the kernel (or for dense the plain version) in
        every layer -> (logits, caches, layer 0's attention output). With
        drop_block the top selected block is marked not ok."""
        seen = []
        name = entry[kind]
        real = getattr(KLA, name)

        def call(*args):
            if drop_block:               # (q, hot_k, ..., ids, ok, scale)
                ok = args[7].clone()
                ok[:, :, 0] = False
                args = args[:7] + (ok,) + args[8:]
            out = plain_dense(*args) if plain else real(*args)
            if not seen:
                seen.append(out)
            return out

        setattr(KLA, name, call)
        try:
            lg, caches = lm.decode_step(cfg, model, tok, caches, kind)
        finally:
            setattr(KLA, name, real)
        return lg.float(), caches, seen[0]

    tok = logits.argmax(-1)
    errs, floor_errs, l0_errs, ctl, own, own_floor = [], [], [], [], [], []
    launches = 0
    picks = expert_picks()
    moe = cfg.family == "moe"

    def forced(what):
        return getattr(picks, what)() if moe else contextlib.nullcontext()

    for _ in range(AGREE_STEPS):
        n0 = kernel.launches
        with forced("record"):
            ld, dense, d0 = step(dense, "dense")
        n1 = kernel.launches
        # the control and the tiered step with its own routing first, on
        # the same cache: each writes only the hot slot that the real
        # step then overwrites, and their counters are dropped
        with forced("replay"):
            lc, _, c0 = step(fork(tiered), "lsm", drop_block=True)
        if moe:
            free = expert_picks()
            with free.record():
                lo, _, _ = step(fork(tiered), "lsm")
            own.append(dict(rel_l2=rel_l2(lo, ld),
                            experts_differ=free.differ(picks)))
        n2 = kernel.launches
        with forced("replay"):
            lt, tiered, t0 = step(tiered, "lsm")
        per_step = lm.n_attention(cfg)
        if (n1 - n0, kernel.launches - n2) != (per_step, per_step):
            raise AssertionError("lm_agree: a decode path skipped the kernel")
        launches += n1 - n0 + kernel.launches - n2
        if not bool(torch.isfinite(ld).all() & torch.isfinite(lt).all()):
            raise AssertionError("lm_agree: a logit is not finite")
        errs.append(rel_l2(lt, ld))
        l0_errs.append(att_close(t0, d0, cfg.dtype))
        if att_within(c0, d0, cfg.dtype):
            raise AssertionError("lm_agree: layer 0 with a selected block "
                                 "masked out passes the kernel tolerance")
        ctl.append(dict(layer0_max_abs_err=float(
            (c0.float() - d0.float()).abs().max()), rel_l2=rel_l2(lc, ld)))
        # the noise floor: the same dense step with the plain version's
        # f32 arithmetic in place of the kernel (same positions, another
        # summation order, bf16 rounding through all layers); for moe,
        # first with its own routing on the slot the forced step rewrites
        if moe:
            lf, _, _ = step(fork(floor), "dense", plain=True)
            own_floor.append(rel_l2(lf, ld))
        with forced("replay"):
            lp, floor, _ = step(floor, "dense", plain=True)
        floor_errs.append(rel_l2(lp, ld))
        tok = ld.argmax(-1)
    window = decode_window(cfg, model, tiered, tok) if moe else {}
    if cfg.dtype == "float32":
        limits = [F32_LIMIT] * len(errs)
    elif cfg.family in ("hybrid", "vlm"):
        limits = [max(AGREE_LIMIT, FLOOR_X * f) for f in floor_errs]
    else:
        limits = [AGREE_LIMIT] * len(errs)
    if any(e > lim for e, lim in zip(errs, limits)):
        raise AssertionError(f"{cfg.name} agree: tiered vs dense rel L2 "
                             f"{errs} over {limits} (dense floor "
                             f"{floor_errs})")
    if cfg.dtype == "float32" and min(c["rel_l2"] for c in ctl) <= F32_LIMIT:
        raise AssertionError(f"{cfg.name} agree: the logits with a selected "
                             f"block masked out pass {F32_LIMIT}: {ctl}")
    own_limit = max(AGREE_LIMIT, FLOOR_X * max(own_floor, default=0.0))
    if moe and max(o["rel_l2"] for o in own) > own_limit:
        raise AssertionError(f"{cfg.name} agree: own-routing tiered vs "
                             f"dense rel L2 {own} over {own_limit} "
                             f"(floor {own_floor})")
    return dict(arch=cfg.name, prompt=AGREE_PROMPT, steps=AGREE_STEPS,
                n_blocks=n_blk, launches=launches,
                max_rel_l2=max(errs), rel_l2=errs,
                limit=limits if cfg.family in ("hybrid", "vlm")
                else limits[0],
                plain_vs_kernel_dense_rel_l2=floor_errs,
                layer0_max_abs_err=l0_errs,
                layer0_mean_abs_out=float(d0.float().abs().mean()),
                block_masked_control=ctl, **window,
                **(dict(forced_routing=True, own_routing=own,
                        own_routing_floor=own_floor,
                        own_routing_limit=own_limit) if moe else {}))


def moe_serve_phase(device, seed: int, counters: dict) -> dict:
    """`moe_serve`: `lm_serve_phase` for Granite-MoE-1B-A400M at full
    width and depth (24 layers: 24 x 31 = 744 in-place launches)."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    model, caches, rec = lm_serve_phase(device, seed, counters,
                                        get_config(MOE_SERVE_ARCH))
    del model, caches
    rec["phase_s"] = time.perf_counter() - t0
    return rec


def moe_agree_phase(device, seed: int):
    """`moe_agree`: Qwen3-30B-A3B at full width and depth (~30.1 B
    parameters in bf16), tiered against dense decode by `lm_agree_phase`
    with the dense step's expert choices replayed (see there), then a
    profiled decode window; peak memory from before the weights are
    made."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config(MOE_AGREE_ARCH)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = lm.init_params(cfg, seed, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = list(model.parameters())
    rec = lm_agree_phase(cfg, model, seed)
    rec.update(init_s=init_s, parameters=sum(p.numel() for p in params),
               weight_bytes=sum(p.numel() * p.element_size()
                                for p in params),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               phase_s=time.perf_counter() - t0)
    del model, params
    return rec


def hybrid_kernel_phase(device, seed: int) -> list:
    """`lsm_kernel` at Zamba2-1.2B's shared-block shape: q (2, 32, 64),
    kv 32, a query group of 1 (one head a pass), the tiered bf16 case of
    `lsm_kernel_phase` with its planted faults and tolerance."""
    from repro_torch.configs import get_config
    recs = lsm_kernel_cases(device, seed, get_config(HYBRID_ARCH),
                            (("tiered", "bfloat16"),))
    for rec in recs:
        rec["case"] = f"hybrid {HYBRID_ARCH}: {rec['case']}"
    return recs


def teacher_forced(cfg, model, batch: dict, cut: int, steps: int) -> dict:
    """Prefill the first `cut` tokens of `batch`, decode the next `steps`
    given tokens, and hold each step's logits (and the prefill's last)
    against `forward` over the whole batch at the same position. The
    bf16 floor is the bf16 forward against an f32 forward of the same
    weights (and inputs) at those positions; a step's limit is
    AGREE_LIMIT, or FLOOR_X times its floor if that is more. The sharp
    check is the same one on an f32 copy, held to F32_LIMIT."""
    import copy
    import torch
    from repro_torch.models import lm
    from repro_torch.serving import grow_dense

    s = batch["tokens"].shape[1]
    at = torch.arange(cut - 1, cut + steps)             # logits' positions

    def head(m, hidden):
        return m.lm_head(hidden[:, at.to(hidden.device)])[..., :cfg.vocab]

    def decoded(c, m, b):
        lg, caches = lm.prefill_step(c, m, dict(b, tokens=b["tokens"][:,
                                                                      :cut]))
        caches = grow_dense(c, caches, s)
        out = [lg]
        for i in range(steps):
            lg, caches = lm.decode_step(c, m, b["tokens"][:, cut + i],
                                        caches)
            out.append(lg)
        return torch.stack(out, dim=1)

    def errs(got, want):
        return [rel_l2(got[:, i], want[:, i]) for i in range(got.shape[1])]

    with torch.no_grad():
        full = head(model, lm.forward(cfg, model, batch)[0])
        dec = decoded(cfg, model, batch)
        c32 = dataclasses.replace(cfg, dtype="float32")
        m32 = copy.deepcopy(model).float()
        b32 = {k: t.float() if t.is_floating_point() else t
               for k, t in batch.items()}
        full32 = head(m32, lm.forward(c32, m32, b32)[0])
        dec32 = decoded(c32, m32, b32)
    if not bool(torch.isfinite(dec).all() & torch.isfinite(full).all()):
        raise AssertionError(f"{cfg.name} teacher-forced: a logit is not "
                             "finite")
    bf16, floor, f32 = errs(dec, full), errs(full, full32), errs(dec32,
                                                                  full32)
    limits = [max(AGREE_LIMIT, FLOOR_X * f) for f in floor]
    del m32
    if any(e > lim for e, lim in zip(bf16, limits)) or max(f32) > F32_LIMIT:
        raise AssertionError(f"{cfg.name} teacher-forced: decode vs forward "
                             f"rel L2 {bf16} over {limits} (bf16 floor "
                             f"{floor}), or in f32 {f32} over "
                             f"{F32_LIMIT}")
    return dict(check_prefill=cut, check_steps=steps,
                decode_vs_forward_rel_l2=bf16, max_rel_l2=max(bf16),
                bf16_floor_rel_l2=floor, limit=limits,
                f32_decode_vs_forward_rel_l2=f32,
                f32_max_rel_l2=max(f32), f32_limit=F32_LIMIT)


def ssm_serve_phase(device, seed: int, counters: dict) -> dict:
    """`ssm_serve`: Mamba2-370M at full width and depth (bf16, seeded
    random weights): `generate` (the state decode; an ssm model has no
    KV cache to tier) for 2 x SSM_PROMPT-token prompts and SERVE_STEPS
    new tokens. It launches no hand-written kernel: the SSD and the
    decode step are plain PyTorch, as the reference's are plain jnp, and
    the counters, set to 0 just before `generate`, must stay 0. Then
    `teacher_forced`; decode ms a step, prefill s, a decode window's
    device-busy share, peak memory from before the weights are made."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving import generate

    cfg = get_config(SSM_ARCH)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = lm.init_params(cfg, seed, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(seed + 9)
    prompt = torch.randint(0, cfg.vocab, (2, SSM_PROMPT), generator=gen)
    for fn in counters.values():
        fn.launches = 0
    stats = {}
    toks, caches = generate(cfg, model, {"tokens": prompt}, SERVE_STEPS,
                            "dense", stats=stats)
    launches = {k: fn.launches for k, fn in counters.items()}
    if any(launches.values()):
        raise AssertionError(f"ssm_serve launched kernels: {launches}")
    if not stats["finite"]:
        raise AssertionError(f"{cfg.name} serve: a logit was not finite")
    if toks.shape != (2, SERVE_STEPS) or not (
            (toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"{cfg.name} serve: bad tokens "
                             f"{tuple(toks.shape)}")
    pos = caches["pos"].unique().tolist()
    if pos != [SSM_PROMPT + SERVE_STEPS - 1]:
        raise AssertionError(f"{cfg.name} serve: pos {pos}")
    n_steps = SERVE_STEPS - 1
    params = list(model.parameters())
    rec = dict(
        arch=cfg.name, dtype=cfg.dtype, batch=2, prompt=SSM_PROMPT,
        new_tokens=SERVE_STEPS, init_s=init_s,
        parameters=sum(p.numel() for p in params),
        prefill_s=stats["prefill_s"],
        decode_ms_per_step=stats["decode_s"] / n_steps * 1e3,
        decode_tokens_per_s=2 * n_steps / stats["decode_s"],
        launches=launches, kernels_launched="none (plain PyTorch SSD and "
        "state decode, as the reference's plain jnp)")
    rec.update(decode_window(cfg, model, caches, toks[:, -1]))
    del caches, params
    # the chunked SSD against the recurrent state decode: prefill S - 256
    # tokens (a multiple of the SSD's chunk), SSM_CHECK_STEPS decoded
    rec.update(teacher_forced(cfg, model, {"tokens": prompt},
                              SSM_PROMPT - 256, SSM_CHECK_STEPS))
    rec.update(max_memory_allocated=torch.cuda.max_memory_allocated(),
               phase_s=time.perf_counter() - t0)
    del model
    return rec


def hybrid_phases(device, seed: int, counters: dict) -> tuple:
    """`hybrid_serve` and `hybrid_agree`: Zamba2-1.2B at full width and
    depth (bf16, seeded random weights; 38 Mamba-2 blocks and one shared
    attention block applied after every 6th, 6 applications each with
    its own tiered KV cache). `lm_serve_phase`: 2 x 24,576-token prompts
    (23 cold blocks an application), 32 new tokens, exactly 6 in-place
    kernel launches a step (186); `lm_seal_phase` on the shared stack;
    then `lm_agree_phase` at 2 x 8,192 tokens, in bf16 and on an f32
    copy of the weights (the check that sees a masked block in the
    logits). Peak memory from before the weights are made."""
    import copy
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(HYBRID_ARCH)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, caches, serve = lm_serve_phase(device, seed, counters, cfg)
    serve["parameters"] = sum(p.numel() for p in model.parameters())
    seal = lm_seal_phase(cfg, model, caches, seed)
    serve.update(max_memory_allocated=torch.cuda.max_memory_allocated(),
                 phase_s=time.perf_counter() - t0)
    del caches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    agree = lm_agree_phase(cfg, model, seed)
    agree.update(max_memory_allocated=torch.cuda.max_memory_allocated(),
                 phase_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    c32 = dataclasses.replace(cfg, dtype="float32")
    m32 = copy.deepcopy(model).float()
    del model
    torch.cuda.reset_peak_memory_stats()
    agree32 = lm_agree_phase(c32, m32, seed)
    agree32.update(max_memory_allocated=torch.cuda.max_memory_allocated(),
                   phase_s=time.perf_counter() - t0)
    del m32
    return serve, seal, agree, agree32


def vlm_kernel_phase(device, seed: int) -> list:
    """`vlm_kernel`: `lsm_kernel` at Qwen2-VL-7B's tiered shape: q (2, 28,
    128), kv 4, a query group of 7 (`per_pass` takes one head: seven
    passes, each reading every K/V row), the tiered bf16 case of
    `lsm_kernel_phase` with its planted faults and tolerance."""
    from repro_torch.configs import get_config
    recs = lsm_kernel_cases(device, seed, get_config(VLM_ARCH),
                            (("tiered", "bfloat16"),))
    for rec in recs:
        rec["case"] = f"vlm {VLM_ARCH}: {rec['case']}"
    return recs


def vlm_phases(device, seed: int, counters: dict) -> tuple:
    """`vlm_serve` and `vlm_agree`: Qwen2-VL-7B at full width and depth
    (bf16, seeded random weights; text `positions3`, three equal M-RoPE
    streams). `lm_serve_phase`: 2 x 24,576-token prompts, 32 new tokens,
    exactly 28 x 31 = 868 in-place kernel launches; `lm_seal_phase`;
    then `lm_agree_phase` at 2 x 8,192 tokens: the dense step applies
    M-RoPE, the tiered step RoPE (as in the reference), equal for equal
    streams. Peak memory from before the weights are made."""
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(VLM_ARCH)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, caches, serve = lm_serve_phase(device, seed, counters, cfg)
    serve["parameters"] = sum(p.numel() for p in model.parameters())
    seal = lm_seal_phase(cfg, model, caches, seed)
    serve.update(max_memory_allocated=torch.cuda.max_memory_allocated(),
                 phase_s=time.perf_counter() - t0)
    del caches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    agree = lm_agree_phase(cfg, model, seed)
    agree.update(max_memory_allocated=torch.cuda.max_memory_allocated(),
                 phase_s=time.perf_counter() - t0)
    del model
    return serve, seal, agree


def encdec_kernel_phase(device, seed: int) -> list:
    """`encdec_kernel`: `lsm_kernel`'s dense case (by lengths) at
    Whisper-tiny's two decode shapes, q (2, 6, 64), kv 6, a group of 1:
    the decoder's self-attention cache of `generate` (8 + 440 + 8
    positions, lengths 224 and 448) and its cross-attention over the
    encoder's 1,500 positions (lengths 1,500), bf16, with the planted
    fault and tolerance."""
    from repro_torch.configs import get_config
    cfg = get_config(ENCDEC_ARCH)
    recs = []
    for what, dense in (
            ("self", (ENCDEC_PROMPT + ENCDEC_STEPS + 8, (224, 448))),
            ("cross", (cfg.encoder_seq, (cfg.encoder_seq,) * 2))):
        for rec in lsm_kernel_cases(device, seed, cfg,
                                    (("dense", "bfloat16"),), dense):
            rec["case"] = f"encdec {ENCDEC_ARCH} {what}: {rec['case']}"
            recs.append(rec)
    return recs


def encdec_serve_phase(device, seed: int, counters: dict) -> dict:
    """`encdec_serve`: Whisper-tiny at full width and depth (bf16, seeded
    random weights and frames (2, 1500, 384) in the model dtype).
    `generate(kind="dense")` for 2 x ENCDEC_PROMPT tokens and
    ENCDEC_STEPS new ones (the 448 learned positions filled): exactly
    two kernel launches a decoder layer a step (self- and
    cross-attention), no tiered one; `generate(kind="lsm")` must raise
    ValueError (the decoder is never tiered); then `teacher_forced` over
    the whole 448 tokens; decode ms a step, the encoder's device ms, a
    decode window's device-busy share, peak memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.lsm_attention import ops as KLA
    from repro_torch.models import lm
    from repro_torch.serving import generate

    cfg = get_config(ENCDEC_ARCH)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = lm.init_params(cfg, seed, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device).manual_seed(seed + 10)
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device=device).to(getattr(torch, cfg.dtype))
    gen = torch.Generator().manual_seed(seed + 11)
    tokens = torch.randint(0, cfg.vocab, (2, ENCDEC_PROMPT + ENCDEC_STEPS),
                           generator=gen)
    batch = {"tokens": tokens[:, :ENCDEC_PROMPT], "frames": frames}
    for fn in (*counters.values(), KLA.lsm_decode_attention):
        fn.launches = 0
    stats = {}
    toks, caches = generate(cfg, model, batch, ENCDEC_STEPS, "dense",
                            stats=stats)
    launches = {k: fn.launches for k, fn in counters.items()}
    tiered = KLA.lsm_decode_attention.launches
    n_steps = ENCDEC_STEPS - 1
    want = 2 * cfg.n_layers * n_steps
    if launches["lsm_attention"] != want or tiered:
        raise AssertionError(f"encdec_serve: lsm_attention launched "
                             f"{launches['lsm_attention']} times ({tiered} "
                             f"tiered), expected {want}: a self- and a "
                             "cross-attention a layer a step")
    if not stats["finite"]:
        raise AssertionError(f"{cfg.name} serve: a logit was not finite")
    if toks.shape != (2, ENCDEC_STEPS) or not (
            (toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"{cfg.name} serve: bad tokens "
                             f"{tuple(toks.shape)}")
    pos = caches["pos"].unique().tolist()
    if pos != [ENCDEC_PROMPT + n_steps]:
        raise AssertionError(f"{cfg.name} serve: pos {pos}")
    try:
        generate(cfg, model, batch, 2, "lsm")
    except ValueError as e:
        lsm_refused = str(e)
    else:
        raise AssertionError(f"{cfg.name}: generate(kind='lsm') did not "
                             "raise")
    params = list(model.parameters())
    rec = dict(
        arch=cfg.name, dtype=cfg.dtype, batch=2, prompt=ENCDEC_PROMPT,
        new_tokens=ENCDEC_STEPS, frames=list(frames.shape), init_s=init_s,
        parameters=sum(p.numel() for p in params),
        prefill_s=stats["prefill_s"],
        decode_ms_per_step=stats["decode_s"] / n_steps * 1e3,
        decode_tokens_per_s=2 * n_steps / stats["decode_s"],
        encoder_ms=device_ms(lambda: lm._encode(cfg, model, frames), 10),
        encoder_wall_ms=wall_ms(lambda: lm._encode(cfg, model, frames), 10),
        launches=launches, lsm_refused=lsm_refused)
    rec.update(decode_window(cfg, model, caches, toks[:, -1]))
    del caches, params
    rec.update(teacher_forced(cfg, model, {"tokens": tokens,
                                           "frames": frames},
                              ENCDEC_PROMPT, ENCDEC_STEPS))
    rec.update(max_memory_allocated=torch.cuda.max_memory_allocated(),
               phase_s=time.perf_counter() - t0)
    del model
    return rec


def train_phase(device, seed: int, counters: dict, cfg=None) -> dict:
    """`train`: `make_train_step(base_lr=TRAIN_LR, warmup=TRAIN_WARMUP)`
    for TRAIN_STEPS steps on one repeated TokenStream(seed=0) batch of
    TRAIN_BATCH x TRAIN_SEQ tokens, from seeded random weights: every loss
    finite and the last below the first, no lsm_attention (or engine
    kernel) launch; step ms between CUDA events (the first step apart),
    tokens/s, peak memory from before the weights, and one more step's
    device-busy share."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import lm
    from repro_torch.train import adamw_init, make_train_step

    cfg = cfg or get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = lm.init_params(cfg, seed, device)
    opt = adamw_init(model)
    step = make_train_step(cfg, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP)
    batch = next(TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0))
    # the step's arguments: weights, AdamW moments and step, the batch
    argument_bytes = (sum(t.nbytes for t in model.parameters())
                      + sum(t.nbytes for t in (*opt.mu.values(),
                                               *opt.nu.values(), opt.step))
                      + sum(a.nbytes for a in batch.values()))
    for fn in counters.values():
        fn.launches = 0
    events, metrics = [], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        model, opt, m = step(model, opt, batch)
        stop.record()
        events.append((start, stop))
        metrics.append(m)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(m["loss"]) for m in metrics]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: a loss was not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the last loss is not below the "
                             f"first: {losses}")
    if any(launches.values()):
        raise AssertionError(f"train: a counted kernel launched: {launches}")
    steady = sum(ms[1:]) / (len(ms) - 1)
    rec = dict(arch=cfg.name, dtype=cfg.dtype, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, steps=TRAIN_STEPS, base_lr=TRAIN_LR,
               warmup=TRAIN_WARMUP, parameters=lm.param_count(model),
               losses=losses,
               aux_losses=[float(m["aux_loss"]) for m in metrics],
               grad_norms=[float(m["grad_norm"]) for m in metrics],
               lrs=[float(m["lr"]) for m in metrics],
               first_step_ms=ms[0], step_ms=steady, step_ms_each=ms,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / steady * 1e3,
               launches=launches, argument_bytes=argument_bytes,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    busy, by_name = flow_busy(lambda: step(model, opt, batch))
    rec.update(busy_step=busy,
               top_kernels_ms={kernel_name(k): v / 1e3 for k, v in
                               sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:6]},
               phase_s=time.perf_counter() - t0)
    del model, opt
    return rec


def grads_held(got_mu, want_mu) -> tuple:
    """Each leaf's gradient (its first moment) against `want_mu`: ->
    (worst error over the leaf's largest, its leaf, leaves out of
    GRAD_RTOL plus GRAD_ATOL_OF_MAX of the leaf's largest, the smallest
    leaf maximum)."""
    worst, worst_leaf, bad, least = 0.0, None, [], math.inf
    for n, a in got_mu.items():
        b = want_mu[n].to(a.device)
        top = float(b.abs().max())
        err = (a - b).abs()
        if not bool((err <= GRAD_RTOL * b.abs()
                     + GRAD_ATOL_OF_MAX * top).all()):
            bad.append(n)
        share = float(err.max()) / top if top else float(err.max())
        if share >= worst:
            worst, worst_leaf = share, n
        least = min(least, top)
        del b, err
    return worst, worst_leaf, bad, least


def named(model) -> dict:
    return dict(model.named_parameters())


def held(what, got, got_params, got_mu, want, want_params, want_mu,
         bound) -> dict:
    """Two train steps' metrics within TRAIN_REL, gradients (first
    moments, {name: tensor}) by `grads_held`, parameters ({name:
    tensor}) within `bound`; raises otherwise."""
    rel = {k: abs(got[k] - want[k]) / abs(want[k])
           for k in ("loss", "grad_norm")}
    g_share, g_leaf, g_bad, g_least = grads_held(got_mu, want_mu)
    errs = {n: float((a.cpu() - want_params[n].cpu()).abs().max())
            for n, a in got_params.items()}
    worst = max(errs, key=errs.get)
    out = dict(rel=rel, grad_err_of_leaf_max=g_share,
               worst_grad=g_leaf, grads_out_of_bounds=g_bad,
               least_leaf_max_mu=g_least,
               grad_rtol=GRAD_RTOL, grad_atol_of_max=GRAD_ATOL_OF_MAX,
               max_param_err=errs[worst], worst_param=worst, bound=bound)
    if (max(rel.values()) > TRAIN_REL or g_bad or not g_least > 0
            or errs[worst] > bound):
        raise AssertionError(f"{what}: {out}")
    return out


DRYRUN_CELLS = {   # the dry run of two shapes this smoke measures for real
    "train": (TRAIN_ARCH, dict(kind="train", seq=TRAIN_SEQ,
                                batch=TRAIN_BATCH)),
    "lm_serve": (LM_ARCH, dict(kind="decode", seq=SERVE_PROMPT + SERVE_STEPS,
                               batch=2, decode_kind="lsm")),
}
PEAK_EST_TOL = 0.25             # the dry run's peak against the measured


def dryrun_child(out: str) -> int:
    """`--dryrun-child JSON`: `launch.dryrun` of DRYRUN_CELLS on fake CUDA
    tensors over a fake (1, 1) world (a process of its own: the `mesh`
    phase opened NCCL in the parent) -> the records in JSON. (Without a
    card the tensors are fake CPU tensors: a rehearsal.)"""
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1, 1, device=DR.fake_device(), fake=True)
    recs = {key: DR.run_cell(arch, key, False, force=True, spec=spec,
                             mesh=mesh, out_dir=ROOT / "build" / "dryrun")
            for key, (arch, spec) in DRYRUN_CELLS.items()}
    Path(out).write_text(json.dumps(recs))
    return 0 if all("error" not in r for r in recs.values()) else 1


def start_dryrun():
    """Start the `dryrun` phase's child (CPU work on fake tensors, no
    kernel), so that it runs beside the phases after it; killed at exit
    if it outlives the smoke. -> (the process, its output file)."""
    import atexit
    out = ROOT / "build" / "dryrun" / "smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".log"), "w") as log_file:
        proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                 "--dryrun-child", str(out)],
                                stdout=log_file, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out


def dryrun_phase(train: dict, serve: dict, card: str, started) -> dict:
    """`dryrun`: the dry run's estimate of the `train` phase's step
    (Granite-MoE-1B-A400M, 4 x 256) and of `lm_serve`'s tiered decode
    step (Phi-4-mini, batch 2) against what those phases measured: the
    argument bytes exactly the real weights, AdamW state and batch; the
    estimated peak within PEAK_EST_TOL of `max_memory_allocated`;
    `train_mfu` = model FLOPs / step s / the bf16 peak and
    `decode_hbm_share` = bytes_floor / decode s a step / HBM's rate,
    each finite and at most 1 (above the peak, the count is wrong).
    `started` is `start_dryrun()`'s child, waited for here."""
    from repro_torch.launch import cost

    proc, out = started
    if proc.wait(timeout=600):
        raise AssertionError(f"dryrun child exited {proc.returncode}: "
                             f"{out.with_suffix('.log').read_text()[-5000:]}")
    recs = json.loads(out.read_text())
    t, d = recs["train"], recs["lm_serve"]
    est_args = t["memory"]["argument_size_in_bytes"]
    peak_ratio = (t["memory"]["peak_size_in_bytes"]
                  / train["max_memory_allocated"])
    shares = {
        "train_mfu": t["model_flops"] / (train["step_ms"] * 1e-3)
        / cost.PEAK_BF16_FLOPS,
        "decode_hbm_share": d["bytes_floor"]
        / (serve["decode_ms_per_step"] * 1e-3) / cost.HBM_BYTES_PER_S}
    rec = dict(
        train_argument_bytes=est_args,
        train_argument_bytes_real=train["argument_bytes"],
        train_peak_bytes=t["memory"]["peak_size_in_bytes"],
        train_peak_bytes_real=train["max_memory_allocated"],
        train_peak_ratio=peak_ratio,
        train_model_flops=t["model_flops"], train_step_ms=train["step_ms"],
        train_hlo_flops=t["hlo_flops_per_dev"],
        decode_bytes_floor=d["bytes_floor"],
        decode_ms_per_step=serve["decode_ms_per_step"],
        decode_kernels=d["kernels"], trace_s=[t["compile_s"],
                                              d["compile_s"]], **shares)
    for k, v in shares.items():
        log(f"{k} = {v!r} [{card}]")
    if est_args != train["argument_bytes"]:
        raise AssertionError(f"dryrun: argument bytes {est_args}, the real "
                             f"step's {train['argument_bytes']}")
    if abs(peak_ratio - 1) > PEAK_EST_TOL:
        raise AssertionError(f"dryrun: estimated peak / measured "
                             f"{peak_ratio:.3f}, outside 1 +- {PEAK_EST_TOL}")
    bad = {k: v for k, v in shares.items()
           if not (math.isfinite(v) and 0 < v <= 1)}
    if bad:
        raise AssertionError(f"dryrun: a share above the peak or not "
                             f"finite (the count is wrong): {bad}")
    return rec


def train_agree_phase(device, seed: int, cfg=None) -> dict:
    """`train_agree`: AGREE_TRAIN_ARCH at full width, depth cut to
    AGREE_TRAIN_LAYERS, f32 with TF32 off. One `make_train_step` on the
    card and one on the CPU (the plain PyTorch path) from the same seeded
    weights: loss and grad norm within TRAIN_REL; every parameter's
    gradient leaf by leaf within GRAD_RTOL plus GRAD_ATOL_OF_MAX of the
    leaf's largest, read off the step's first moment (from zero moments
    mu = (1 - b1) * clip scale * gradient, in f32, and the two clip
    scales agree within TRAIN_REL); every updated parameter within
    2 * lr + 1e-6 (Adam's first step turns each gradient entry into about
    +-1, so an entry that is nearly zero may flip its sign and move its
    parameter by up to 2 * lr; from equal weights two first steps differ
    by at most that whatever their gradients, so this bound only catches
    a missing, non-finite or mis-scheduled update, and the gradients are
    what hold the backward). Then accum_steps 4 against 1 on the card at
    the same bounds."""
    import copy

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import lm
    from repro_torch.train import adamw_init, make_train_step
    from repro_torch.train.optimizer import cosine_schedule

    cfg = cfg or dataclasses.replace(get_config(AGREE_TRAIN_ARCH),
                                     n_layers=AGREE_TRAIN_LAYERS,
                                     dtype="float32")
    t0 = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    try:
        # drawn on the card (a CPU draw of 1.43 B normals takes seconds),
        # then copied to the CPU and to a second model on the card
        card = lm.init_params(cfg, seed, device)
        card4 = copy.deepcopy(card)
        host = lm.LM(cfg, torch.device("cpu")).requires_grad_(False)
        host.load_state_dict(card.state_dict())
        batch = next(TokenStream(cfg.vocab, AGREE_TRAIN_BATCH,
                                 AGREE_TRAIN_SEQ, seed=seed))
        bound = 2 * float(cosine_schedule(TRAIN_LR, TRAIN_WARMUP,
                                          10_000)(1)) + 1e-6

        def one_step(model, accum):
            """-> (metrics, seconds, the first moments; nu is let go)."""
            step = make_train_step(cfg, base_lr=TRAIN_LR,
                                   warmup=TRAIN_WARMUP, accum_steps=accum)
            clock = time.perf_counter()
            model, state, m = step(model, adamw_init(model), batch)
            m = {k: float(v) for k, v in m.items()}     # waits for the step
            return m, time.perf_counter() - clock, state.mu

        m_card, card_s, mu_card = one_step(card, 1)
        m_cpu, cpu_s, mu_cpu = one_step(host, 1)
        m_card4, card4_s, mu_card4 = one_step(card4, 4)
        rec = dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
                   tf32=False, batch=AGREE_TRAIN_BATCH, seq=AGREE_TRAIN_SEQ,
                   parameters=lm.param_count(host),
                   metrics={"card": m_card, "cpu": m_cpu,
                            "card accum 4": m_card4},
                   step_s={"card": card_s, "cpu": cpu_s,
                           "card accum 4": card4_s})
        rec["card vs cpu"] = held("train_agree card vs cpu", m_card,
                                  named(card), mu_card, m_cpu, named(host),
                                  mu_cpu, bound)
        rec["accum 4 vs 1"] = held("train_agree accum 4 vs 1", m_card4,
                                   named(card4), mu_card4, m_card,
                                   named(card), mu_card, bound)
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    del host, card, card4, mu_card, mu_cpu, mu_card4
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t0
    return rec


# (name, script, arguments, a line its output must hold)
EXAMPLES = (("quickstart_torch.py", "examples/quickstart_torch.py", [],
             "quickstart OK"),
            ("long_context_serve_torch.py",
             "examples/long_context_serve_torch.py", [], "tiered cache:"),
            ("train_lm_torch.py", "examples/train_lm_torch.py",
             ["--steps", "100", "--ckpt-dir",
              str(ROOT / "build" / "train_lm_torch")],
             "exact bitwise restore expected: OK"),
            ("kv_store_service_torch.py",
             "examples/kv_store_service_torch.py", [],
             "verification: 2,000 sampled keys all correct (newest-wins)"))
# the process-kill twins, each with the success line of its reference
MIRRORS = (("recovery", "tools/recovery_smoke_torch.py", [],
            "OK: restore is oracle-exact"),
           ("replication", "tools/replication_smoke_torch.py", [],
            "OK: failover is answer-exact"),
           ("partition", "tools/replication_smoke_torch.py",
            ["--partition"], "OK: automatic promotion in"),
           ("failover_demo", "examples/failover_demo_torch.py", [],
            "OK: automatic failover -> fence -> rejoin, all answer-exact"))


def start_scripts(entries, logs: Path):
    """Start each (name, script, arguments, expect) entry as a subprocess
    on the card (the scripts' default device), all at once; its output
    in `logs`. -> (the processes by name, their common start)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    logs.mkdir(parents=True, exist_ok=True)
    runs = {}
    for name, script, extra, _ in entries:
        with open(logs / f"{name}.out", "w") as out, \
                open(logs / f"{name}.err", "w") as err:
            runs[name] = subprocess.Popen(
                [sys.executable, str(ROOT / script), *extra],
                stdout=out, stderr=err, env=env, cwd=ROOT)
    return runs, time.perf_counter()


def finish_scripts(entries, logs: Path, started, limit_s: float = 600) -> dict:
    """Wait for `start_scripts`' processes: each must exit 0 with its
    line in its output; -> seconds each from the common start to its
    exit (as polled), and its last line. Kills what is left on the way
    out."""
    runs, t0 = started
    done = {}
    try:
        while len(done) < len(runs):
            for name, proc in runs.items():
                if name not in done and proc.poll() is not None:
                    done[name] = time.perf_counter() - t0
            if time.perf_counter() - t0 > limit_s:
                raise AssertionError(f"still running after {limit_s} s: "
                                     f"{sorted(set(runs) - set(done))}")
            time.sleep(0.2)
    finally:
        for proc in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = {}
    for name, _, _, expect in entries:
        text = (logs / f"{name}.out").read_text()
        if runs[name].returncode or expect not in text:
            raise AssertionError(
                f"{name} failed (rc {runs[name].returncode}):\n"
                f"{text}\n{(logs / f'{name}.err').read_text()}")
        out[name] = dict(s=done[name],
                         last_line=text.strip().splitlines()[-1])
    return out


# --------------------------------------------------------------------------
# distributed/ on a one-rank mesh
# --------------------------------------------------------------------------

MESH_SEQ = 1_024                # moe_mesh: 2 x 1,024 tokens
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 4, 256


class first_output:
    """Keeps the first output of `owner.name` (a function) under the
    context, and counts its calls; the function is put back on exit."""

    def __init__(self, owner, name: str, pick=lambda out: out):
        self.owner, self.name, self.pick = owner, name, pick
        self.first, self.calls = None, 0

    def __enter__(self):
        real = self.real = getattr(self.owner, self.name)

        def call(*args, **kw):
            out = real(*args, **kw)
            if self.calls == 0:
                got = self.pick(out)
                self.first = (got.full_tensor() if hasattr(got, "full_tensor")
                              else got).detach().clone()
            self.calls += 1
            return out
        setattr(self.owner, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)


def on_mesh(mesh):
    """Register the (data, model) mesh with the model code for a block."""
    from repro_torch.distributed import runtime as RT

    @contextlib.contextmanager
    def ctx():
        RT.set_axes(("data",), "model", mesh)
        try:
            yield
        finally:
            RT.clear()
    return ctx()


def moe_mesh_check(device, seed: int, mesh, counters: dict) -> dict:
    """Granite-MoE at full width and depth: `logits_full` of 2 x MESH_SEQ
    tokens on the single-device path, then with the parameters and batch
    laid out as DTensors by the sharding rules and the mesh registered:
    every layer's `moe_ffn` must take its mesh branch; layer 0's FFN
    output at the kernel tolerance, logits within AGREE_LIMIT."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE

    cfg = get_config(MOE_SERVE_ARCH)
    model = lm.init_params(cfg, seed, device)
    gen = torch.Generator().manual_seed(seed + 20)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, MESH_SEQ),
                                     generator=gen).to(device)}
    with first_output(lm, "moe_ffn", lambda o: o[0]) as single, \
            first_output(MOE, "_moe_mesh", lambda o: o[0]) as branch:
        want = lm.logits_full(cfg, model, batch)
    if branch.calls:
        raise AssertionError("moe_mesh: the mesh branch ran with no mesh")
    SH.distribute_model(model, mesh, SH.param_pspecs(cfg, model, mesh))
    dbatch = SH.distribute(batch, mesh, SH.batch_pspecs(cfg, batch, mesh))
    n0 = {k: fn.launches for k, fn in counters.items()}
    with on_mesh(mesh), first_output(lm, "moe_ffn", lambda o: o[0]) as got0, \
            first_output(MOE, "_moe_mesh", lambda o: o[0]) as branch:
        got = lm.logits_full(cfg, model, dbatch).full_tensor()
    torch.cuda.synchronize()
    if branch.calls != cfg.n_layers:
        raise AssertionError(f"moe_mesh: mesh branch ran {branch.calls} "
                             f"times for {cfg.n_layers} layers")
    err0 = att_close(got0.first, single.first, cfg.dtype)
    rel = rel_l2(got, want)
    if not (rel <= AGREE_LIMIT and bool(torch.isfinite(got).all())):
        raise AssertionError(f"moe_mesh: logits rel L2 {rel} > "
                             f"{AGREE_LIMIT}")
    return dict(arch=cfg.name, tokens=list(batch["tokens"].shape),
                mesh_branch_calls=branch.calls, layer0_max_abs_err=err0,
                rel_l2=rel, limit=AGREE_LIMIT,
                kernel_launches={k: fn.launches - n0[k]
                                 for k, fn in counters.items()})


def lsm_mesh_check(device, seed: int, mesh, counters: dict) -> dict:
    """Phi-4-mini at full width and depth, b = 1, an AGREE_PROMPT prompt:
    AGREE_STEPS tiered decode steps teacher-forced by the single-device
    branch (the `lsm_attention` kernel in every layer) and the same
    steps with the mesh registered through the sharded-stats branch
    (every layer). Logits rel L2 within AGREE_LIMIT or FLOOR_X times the
    step's dense floor (the dense step with the plain attention against
    the kernel's); layer 0's attention at the kernel tolerance, which
    the branch with its top selected block masked in every layer must
    fail. -> the kernel's launches on this path among the record."""
    import torch
    from repro_torch.kernels.lsm_attention import ops as KLA
    from repro_torch.models import attention as ATT
    from repro_torch.models import lm
    from repro_torch.serving import grow_dense, lsm_from_dense

    cfg = lm_config()
    model = lm.init_params(cfg, seed, device)
    gen = torch.Generator().manual_seed(seed + 21)
    prompt = torch.randint(0, cfg.vocab, (1, AGREE_PROMPT), generator=gen)
    logits, dense = lm.prefill_step(cfg, model, {"tokens": prompt.to(device)})
    max_len = AGREE_PROMPT + 2 * AGREE_STEPS
    single = lsm_from_dense(cfg, dense, max_len)
    meshed = lsm_from_dense(cfg, dense, max_len)
    dense = grow_dense(cfg, dense, max_len)
    floor = fork(dense, everything=True)
    n_blk = int(single["n_blocks"][0, 0])
    kernel = KLA.decode_attention

    def masked_top(*args, **kw):
        ids, ok = real_select(*args, **kw)
        ok = ok.clone()
        ok[:, :, 0] = False
        return ids, ok

    real_select = KLA.select_blocks
    tok = logits.argmax(-1)
    errs, floors, l0, ctl, launches, stats_calls = [], [], [], [], 0, 0
    for _ in range(AGREE_STEPS):
        n0 = kernel.launches
        with first_output(KLA, "lsm_decode_attention") as s0:
            ls, single = lm.decode_step(cfg, model, tok, single, "lsm")
        launches += kernel.launches - n0
        if kernel.launches - n0 != cfg.n_layers:
            raise AssertionError("lsm_mesh: the single-device branch "
                                 "skipped the kernel")
        n1 = kernel.launches
        with on_mesh(mesh):
            KLA.select_blocks = masked_top
            try:
                with first_output(ATT, "_lsm_stats") as c0:
                    lc, _ = lm.decode_step(cfg, model, tok, fork(meshed),
                                           "lsm")
            finally:
                KLA.select_blocks = real_select
            with first_output(ATT, "_lsm_stats") as m0:
                lm_, meshed = lm.decode_step(cfg, model, tok, meshed, "lsm")
        if kernel.launches != n1 or m0.calls != cfg.n_layers:
            raise AssertionError(f"lsm_mesh: stats branch ran {m0.calls} "
                                 f"times, the kernel {kernel.launches - n1}")
        stats_calls += m0.calls
        ld, dense = lm.decode_step(cfg, model, tok, dense, "dense")
        real = KLA.decode_attention_op
        KLA.decode_attention_op = plain_dense
        try:
            lp, floor = lm.decode_step(cfg, model, tok, floor, "dense")
        finally:
            KLA.decode_attention_op = real
        if not bool(torch.isfinite(lm_).all() & torch.isfinite(ls).all()):
            raise AssertionError("lsm_mesh: a logit is not finite")
        floors.append(rel_l2(lp.float(), ld.float()))
        errs.append(rel_l2(lm_.float(), ls.float()))
        l0.append(att_close(m0.first.to(s0.first.dtype), s0.first,
                            cfg.dtype))
        if att_within(c0.first.to(s0.first.dtype), s0.first, cfg.dtype):
            raise AssertionError("lsm_mesh: layer 0 with the top selected "
                                 "block masked passes the kernel tolerance")
        ctl.append(float((c0.first.float() - s0.first.float()).abs().max()))
        tok = ls.argmax(-1)
    limits = [max(AGREE_LIMIT, FLOOR_X * f) for f in floors]
    if any(e > lim for e, lim in zip(errs, limits)):
        raise AssertionError(f"lsm_mesh: rel L2 {errs} over {limits}")
    return dict(arch=cfg.name, prompt=AGREE_PROMPT, steps=AGREE_STEPS,
                n_blocks=n_blk, stats_branch_calls=stats_calls,
                launches=launches, rel_l2=errs, limit=limits,
                dense_floor_rel_l2=floors, layer0_max_abs_err=l0,
                block_masked_control_layer0_max_abs_err=ctl)


def train_mesh_check(device, seed: int, mesh, counters: dict) -> dict:
    """Granite-MoE at full width and depth in f32, TF32 off: one
    `make_train_step` with DTensor parameters (`param_pspecs`), ZeRO-1
    moments (`zero1_pspecs`) and the batch (`batch_pspecs`) on the mesh,
    against the same step from the same weights with no mesh, at
    train_agree's bounds (`held`); every layer's `moe_ffn` on its mesh
    branch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE
    from repro_torch.train import adamw_init, make_train_step
    from repro_torch.train.optimizer import cosine_schedule

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        gen = torch.Generator().manual_seed(seed + 22)
        shape = (MESH_TRAIN_BATCH, MESH_TRAIN_SEQ)
        batch = {k: torch.randint(0, cfg.vocab, shape, generator=gen).to(
            device) for k in ("tokens", "labels")}
        step = make_train_step(cfg, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP)
        bound = 2 * float(cosine_schedule(TRAIN_LR, TRAIN_WARMUP,
                                          10_000)(1)) + 1e-6
        want_model = lm.init_params(cfg, seed, device)
        clock = time.perf_counter()
        _, want_state, want = step(want_model, adamw_init(want_model), batch)
        want = {k: float(v) for k, v in want.items()}
        plain_s = time.perf_counter() - clock
        want_mu = want_state.mu
        del want_state
        model = lm.init_params(cfg, seed, device)
        opt = adamw_init(model)
        ospecs = SH.zero1_pspecs(cfg, opt, mesh)
        SH.distribute_model(model, mesh, SH.param_pspecs(cfg, model, mesh))
        opt = SH.distribute(opt, mesh, ospecs)
        dbatch = SH.distribute(batch, mesh, SH.batch_pspecs(cfg, batch, mesh))
        clock = time.perf_counter()
        with on_mesh(mesh), first_output(MOE, "_moe_mesh", lambda o: o[0]) as branch:
            _, opt, got = step(model, opt, dbatch)
            got = {k: float(v.full_tensor() if hasattr(v, "full_tensor")
                            else v) for k, v in got.items()}
        mesh_s = time.perf_counter() - clock
        if branch.calls < cfg.n_layers:
            raise AssertionError(f"train_mesh: mesh branch ran "
                                 f"{branch.calls} times")
        rec = held("train_mesh", got,
                   {n: p.full_tensor() for n, p in named(model).items()},
                   {n: m.full_tensor() for n, m in opt.mu.items()}, want,
                   named(want_model), want_mu, bound)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    rec.update(arch=cfg.name, dtype=cfg.dtype, tf32=False,
               batch=list(shape), metrics={"mesh": got, "plain": want},
               step_s={"mesh": mesh_s, "plain": plain_s},
               mesh_branch_calls=branch.calls)
    return rec


def compress_check(device, seed: int, mesh, counters: dict) -> dict:
    """`compress_roundtrip` and one `ef_compress_grads` step of a
    full-size leaf (Granite-MoE's embedding, f32 normals) on the card,
    bitwise equal to the CPU's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import compress as TC

    cfg = get_config(MOE_SERVE_ARCH)
    gen = torch.Generator().manual_seed(seed + 23)
    host = torch.randn(cfg.padded_vocab, cfg.d_model, generator=gen)
    res = {"embed": torch.randn(host.shape, generator=gen) * 1e-3}
    card = host.to(device)
    clock = time.perf_counter()
    got = TC.compress_roundtrip(card)
    applied, new_res = TC.ef_compress_grads(
        {"embed": card}, {"embed": res["embed"].to(device)})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - clock
    want = TC.compress_roundtrip(host)
    w_applied, w_res = TC.ef_compress_grads({"embed": host}, res)
    same = (torch.equal(got.cpu(), want)
            and torch.equal(applied["embed"].cpu(), w_applied["embed"])
            and torch.equal(new_res["embed"].cpu(), w_res["embed"]))
    if not same:
        raise AssertionError("compress: the card's roundtrip differs from "
                             "the CPU's")
    return dict(leaf=list(host.shape), bitwise=True, card_s=card_s,
                max_abs_err_of_roundtrip=float((want - host).abs().max()))


def mesh_phase(device, seed: int, counters: dict) -> dict:
    """The `mesh` checks on a one-rank NCCL group and a (1, 1) mesh; each
    check's record gets its seconds and peak memory."""
    import socket

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_group, make_host_mesh

    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    init_process_group(device, rank=0, world_size=1,
                       init_method=f"tcp://127.0.0.1:{port}")
    rec = {}
    try:
        mesh = make_host_mesh(1, 1, device=device)
        for name, check in (("moe_mesh", moe_mesh_check),
                            ("lsm_mesh", lsm_mesh_check),
                            ("train_mesh", train_mesh_check),
                            ("compress", compress_check)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            clock = time.perf_counter()
            rec[name] = check(device, seed, mesh, counters)
            rec[name].update(s=time.perf_counter() - clock,
                             max_memory_allocated=
                             torch.cuda.max_memory_allocated())
            log(f"mesh {name}: {rec[name]['s']:.1f} s")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t0
    return rec

# --------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--writes", type=int, default=8_000_000,
                    help="main-phase inserts (800 per 8000 become deletes "
                         "on top); lower only for a rehearsal")
    ap.add_argument("--parent-bloom", metavar="CU",
                    help="a previous csrc/bloom_probe.cu (entry "
                         "bloom_probe_launch, one launch a level), e.g. "
                         "from `git show <commit>:src/repro_torch/csrc/"
                         "bloom_probe.cu`: built into build/bloom_parent/ "
                         "and timed in turns with bloom_probe")
    ap.add_argument("--durable-writer", metavar="DIR",
                    help=argparse.SUPPRESS)   # the killed writer's child
    ap.add_argument("--writer-device", default="cuda",
                    help=argparse.SUPPRESS)
    ap.add_argument("--replica-leader", metavar="DIR",
                    help=argparse.SUPPRESS)   # the replica kill's child
    ap.add_argument("--replica-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dryrun-child", metavar="JSON",
                    help=argparse.SUPPRESS)   # the dryrun phase's child
    args = ap.parse_args()
    if args.dryrun_child:
        sys.path.insert(0, str(ROOT / "src"))
        return dryrun_child(args.dryrun_child)
    if args.durable_writer:
        sys.path.insert(0, str(ROOT / "src"))
        return writer_child(args.durable_writer, args.seed,
                            args.writer_device)
    if args.replica_leader:
        sys.path.insert(0, str(ROOT / "src"))
        return replica_leader_child(args.replica_leader, args.replica_port,
                                    args.seed, args.writer_device)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.slsm_paper import paper_params
    from repro_torch.kernels import _build
    from repro_torch.kernels import bloom_probe as KBP
    from repro_torch.kernels import fence_lookup as KFL
    from repro_torch.kernels import heap_merge as KHM
    from repro_torch.kernels import range_merge as KRM
    from repro_torch.kernels.lsm_attention import ops as KLA

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    device_line = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"device: {name} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    print(smi, flush=True)

    parent_build = None
    if args.parent_bloom:       # built beside the port's five, at once
        lib = ROOT / "build" / "bloom_parent" / "libbloom_probe_parent.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        parent_build = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(Path(args.parent_bloom).resolve())],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build_s = _build.build_all()
    log(f"build: {len(_build.sources())} kernels with nvcc "
        f"{' '.join(_build.NVCC_FLAGS[:2])} in {build_s:.1f} s")
    parent_bloom = None
    if parent_build is not None:
        text, _ = parent_build.communicate()
        if parent_build.returncode:
            raise RuntimeError(f"nvcc failed on {args.parent_bloom}:\n{text}")
        parent_bloom = parent_bloom_levels(lib)
        log(f"parent bloom_probe built from {args.parent_bloom}")
    for src, text in sorted(_build.build_log().items()):
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                                text))
        if regs:
            log(f"  ptxas {src}: {len(regs)} kernel(s), at most {max(regs)} "
                f"registers, {spills} bytes of spill stores")

    rng = np.random.default_rng(args.seed)
    with phase("kernels"):
        kernels = kernel_phase(paper_params(merge_budget=1, range_cand=512),
                               device, rng, parent_bloom)

    counters = {"bloom_probe": KBP.bloom_probe_levels,
                "fence_lookup": KFL.fence_lookup_many,
                "heap_merge": KHM.kway_merge,
                "range_merge": KRM.range_merge,
                "lsm_attention": KLA.decode_attention}
    # the round kernels, kept as the reference contract, must not run
    contract = {"heap_merge rounds": KHM.merge_round,
                "range_merge rounds": KRM.merge_round}
    for fn in (*counters.values(), *contract.values()):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    merges = {}
    with phase("main"), merge_tally(merges, KHM.kway_merge):
        eng, main = main_phase(device, args.seed, args.writes)
    launches = {k: fn.launches for k, fn in counters.items()}
    rounds = {k: fn.launches for k, fn in contract.items()}
    main["heap_merge_by_shape"] = merges
    main["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"main [{card}]: " + json.dumps(main))
    log(f"main launches: {launches} contract rounds: {rounds}")
    missing = [k for k, n in launches.items()
               if n == 0 and k != "lsm_attention"]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    batches = 2 * main["scans"] // SCAN_BATCH   # scans, then aggregates
    if any(rounds.values()) or launches["range_merge"] != batches:
        raise AssertionError(f"main path: range_merge launched "
                             f"{launches['range_merge']} times for "
                             f"{batches} batches, rounds {rounds}")
    batches = main["lookups"] // LOOKUP_BATCH   # one probe launch each
    if launches["bloom_probe"] != batches:
        raise AssertionError(f"main path: bloom_probe launched "
                             f"{launches['bloom_probe']} times for "
                             f"{batches} lookup batches")
    with phase("profile"):
        flows = profile_phase(eng, args.seed)
    for flow, rec in flows.items():
        log(f"profile {flow} [{card}]: " + json.dumps(rec))
    del eng

    with phase("cascade"):
        cascade = cascade_phase(device, args.seed)
    log(f"cascade [{card}]: " + json.dumps(cascade))
    torch.cuda.empty_cache()

    # the adaptive engine's traffic (after its warm-up), the tape windows
    # on it, and the scaled engine's tapes: each path's launches counted
    # from 0 just before its own calls and read just after them
    tallies = {path: LaunchTally(counters, contract)
               for path in ("adaptive", "tape", "tape scaled", "durable",
                            "sharded", "replicated leader",
                            "replicated followers", "replica kill",
                            "scenarios")}
    with phase("adaptive"):
        eng, oracle, adaptive, pool = adaptive_phase(
            device, args.seed, ADAPTIVE_N, tallies["adaptive"])
    log(f"adaptive [{card}]: " + json.dumps(adaptive))
    with phase("adaptive profile"):
        flows, extra = adaptive_profile(eng, args.seed)
    oracle.insert(*extra)
    for flow, rec in flows.items():
        log(f"adaptive profile {flow} [{card}]: " + json.dumps(rec))
    with phase("tape"):
        tape = tape_phase(args.seed, eng, oracle, pool, TAPE_WINDOWS,
                          tallies["tape"])
    log(f"tape [{card}]: " + json.dumps(tape))
    del eng, oracle
    torch.cuda.empty_cache()
    with phase("tape scaled"):
        tape = tape_scaled_phase(device, args.seed, SCALED_WINDOWS,
                                 tallies["tape scaled"])
    log(f"tape scaled [{card}]: " + json.dumps(tape))
    with phase("durable"):
        durable = durable_phase(device, args.seed, DURABLE_INSERTS,
                                tallies["durable"])
    log(f"durable [{card}]: " + json.dumps(durable))
    with phase("killed writer"):
        killed = killed_writer_phase(device, args.seed)
    log(f"killed writer [{card}]: " + json.dumps(killed))
    torch.cuda.empty_cache()
    with phase("sharded"):
        sharded, sharded_cases = sharded_phase(device, args.seed,
                                               tallies["sharded"])
    log(f"sharded [{card}]: " + json.dumps(sharded))
    for rec in kernels:
        rec["cases"].append(sharded_cases[rec["name"]])
    with phase("sharded cascade"):
        cascade = sharded_cascade_phase(device, args.seed)
    log(f"sharded cascade [{card}]: " + json.dumps(cascade))
    torch.cuda.empty_cache()
    with phase("replicated"):
        replicated = replicated_phase(device, args.seed, {
            "leader": tallies["replicated leader"],
            "followers": tallies["replicated followers"]})
    log(f"replicated [{card}]: " + json.dumps(replicated))
    with phase("replica kill"):
        killed = replica_kill_phase(device, args.seed, tallies["replica kill"])
    log(f"replica kill [{card}]: " + json.dumps(killed))
    with phase("scenarios"):
        scen = scenarios_phase(device, args.seed, tallies["scenarios"], card)
    log(f"scenarios [{card}]: {len(scen['runs'])} runs exact in "
        f"{scen['phase_s']:.1f} s")
    for rec in kernels:
        rec["cases"].extend(case for name, case in scen["cases"]
                            if name == rec["name"])
    torch.cuda.empty_cache()
    by_path = {"main": launches}
    for path, tally in tallies.items():
        by_path[path] = tally.counts
        log(f"{path} launches: {tally.counts} contract rounds: "
            f"{tally.rounds}")
        missing = [k for k, n in tally.counts.items()
                   if n == 0 and k != "lsm_attention"]
        if missing or any(tally.rounds.values()):
            raise AssertionError(f"{path} path: never launched {missing}, "
                                 f"rounds {tally.rounds}")

    with phase("lsm_kernel"):
        lsm_rec = lsm_kernel_phase(device, args.seed)
    with phase("lm_serve"):
        model, caches, serve = lm_serve_phase(device, args.seed, counters)
    log(f"lm_serve [{card}]: " + json.dumps(serve))
    with phase("lm_seal"):
        seal = lm_seal_phase(lm_config(), model, caches, args.seed)
    log(f"lm_seal [{card}]: " + json.dumps(seal))
    del caches
    torch.cuda.empty_cache()
    with phase("lm_agree"):
        agree = lm_agree_phase(lm_config(), model, args.seed)
    log(f"lm_agree [{card}]: " + json.dumps(agree))
    del model
    torch.cuda.empty_cache()

    with phase("moe_kernel"):
        moe_cases = moe_kernel_phase(device, args.seed)
    with phase("moe_serve"):
        moe_serve = moe_serve_phase(device, args.seed, counters)
    log(f"moe_serve [{card}]: " + json.dumps(moe_serve))
    torch.cuda.empty_cache()
    with phase("moe_agree"):
        moe_agree = moe_agree_phase(device, args.seed)
    log(f"moe_agree [{card}]: " + json.dumps(moe_agree))
    torch.cuda.empty_cache()

    with phase("hybrid_kernel"):
        hybrid_cases = hybrid_kernel_phase(device, args.seed)
    with phase("ssm_serve"):
        ssm_serve = ssm_serve_phase(device, args.seed, counters)
    log(f"ssm_serve [{card}] (launches no kernel): "
        + json.dumps(ssm_serve))
    torch.cuda.empty_cache()
    with phase("hybrid_serve, hybrid_seal, hybrid_agree"):
        hybrid_serve, hybrid_seal, hybrid_agree, hybrid_f32 = hybrid_phases(
            device, args.seed, counters)
    log(f"hybrid_serve [{card}]: " + json.dumps(hybrid_serve))
    log(f"hybrid_seal [{card}]: " + json.dumps(hybrid_seal))
    log(f"hybrid_agree [{card}]: " + json.dumps(hybrid_agree))
    log(f"hybrid_agree f32 [{card}]: " + json.dumps(hybrid_f32))
    torch.cuda.empty_cache()

    with phase("vlm_kernel"):
        vlm_cases = vlm_kernel_phase(device, args.seed)
    with phase("vlm_serve, vlm_seal, vlm_agree"):
        vlm_serve, vlm_seal, vlm_agree = vlm_phases(device, args.seed,
                                                    counters)
    log(f"vlm_serve [{card}]: " + json.dumps(vlm_serve))
    log(f"vlm_seal [{card}]: " + json.dumps(vlm_seal))
    log(f"vlm_agree [{card}]: " + json.dumps(vlm_agree))
    torch.cuda.empty_cache()
    with phase("encdec_kernel"):
        encdec_cases = encdec_kernel_phase(device, args.seed)
    with phase("encdec_serve"):
        encdec_serve = encdec_serve_phase(device, args.seed, counters)
    log(f"encdec_serve [{card}]: " + json.dumps(encdec_serve))
    torch.cuda.empty_cache()

    with phase("train"):
        train = train_phase(device, args.seed, counters)
    log(f"train [{card}]: " + json.dumps(train))
    torch.cuda.empty_cache()
    # the dry run's child traces on the CPU beside the value checks
    # from here on (train_agree, mesh and the subprocesses)
    dry_started = start_dryrun()
    with phase("train_agree"):
        train_agree = train_agree_phase(device, args.seed)
    log(f"train_agree [{card}]: " + json.dumps(train_agree))
    torch.cuda.empty_cache()

    # the process-kill twins and the example mirrors beside the mesh phase
    script_logs = ROOT / "build" / "scripts"
    scripts_started = start_scripts(MIRRORS + EXAMPLES, script_logs)
    try:
        with phase("mesh"):
            mesh = mesh_phase(device, args.seed, counters)
    finally:
        with phase("mirrors"):
            scripts = finish_scripts(MIRRORS + EXAMPLES, script_logs,
                                     scripts_started)
    for name in ("moe_mesh", "lsm_mesh", "train_mesh", "compress"):
        log(f"mesh {name} [{card}]: " + json.dumps(mesh[name]))
    for what, entries in (("mirrors", MIRRORS), ("examples", EXAMPLES)):
        log(f"{what} [{card}]: " + json.dumps(
            {name: scripts[name] for name, *_ in entries}))
    with phase("dryrun"):
        dry = dryrun_phase(train, serve, card, dry_started)
    log(f"dryrun [{card}]: " + json.dumps(dry))

    for rec in kernels:
        rec["launches"] = launches[rec["name"]]
        rec["launches_by_path"] = {k: v[rec["name"]]
                                   for k, v in by_path.items()}
        rec["card"] = card
    lsm_rec["cases"].extend(moe_cases + hybrid_cases + vlm_cases
                            + encdec_cases)
    lsm_rec.update(launches=serve["launches"]["lsm_attention"],
                   launches_by_path={
                       "lm_serve": serve["launches"]["lsm_attention"],
                       "lm_agree": agree["launches"],
                       "moe_serve": moe_serve["launches"]["lsm_attention"],
                       "moe_agree": moe_agree["launches"],
                       "hybrid_serve":
                           hybrid_serve["launches"]["lsm_attention"],
                       "hybrid_agree": hybrid_agree["launches"],
                       "hybrid_agree_f32": hybrid_f32["launches"],
                       "vlm_serve": vlm_serve["launches"]["lsm_attention"],
                       "vlm_agree": vlm_agree["launches"],
                       "encdec_serve":
                           encdec_serve["launches"]["lsm_attention"],
                       "lsm_mesh": mesh["lsm_mesh"]["launches"]},
                   card=card)
    kernels.append(lsm_rec)
    print(json.dumps({"kernels": kernels}))
    print(device_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
