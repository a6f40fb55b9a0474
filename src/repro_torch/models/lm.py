"""Model assembly for every family: parameters, forward, full logits,
prefill, decode caches and the one-token decode step (port of
`repro.models.lm`). A moe block holds `moe` (`models/moe.py`) where a
dense block holds `mlp`; an ssm block is a norm and a Mamba-2 mixer
(`models/ssm.py`). The hybrid family (Zamba2) is a stack of ssm blocks
plus ONE attention block, `shared`, applied after every
`shared_attn_every`-th of them; each application keeps its own KV cache
(the `shared` stack of the caches). The vlm family (Qwen2-VL) is the
dense stack with M-RoPE over `batch["positions3"]` (3, B, S). The encdec
family (Whisper) runs a bidirectional encoder (`enc_layers`, ordinary
blocks) over stubbed frame embeddings `batch["frames"]` (B, T, d), then
decoder blocks (`DecBlock`) of self-attention, cross-attention over the
encoder's cached K/V (`enc_k`/`enc_v`) and an MLP, with learned decoder
positions (`dec_pos`, 448 of them).

The reference stacks layer weights on a leading L axis and drives them
with `lax.scan`; here the layers are an `nn.ModuleList` looped in
Python, and each cache keeps the reference's stacked (L, B, ...) layout
so that caches convert between the packages leaf for leaf.

`forward` trains: when autograd records, each layer runs as a checkpoint
(`torch.utils.checkpoint`, recomputed in the backward), as the
reference's `jax.checkpoint` on its scan body; the serving entry
points (`forward_collect`, `prefill_step`, `logits_full`,
`decode_step`) run without autograd.

Every entry point runs where the model's parameters lie: `init_params`
puts them on the CUDA card and raises without one unless asked for
`device="cpu"`.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import shape_only
from repro_torch.device import resolve_device
from repro_torch.distributed import runtime as RT
from repro_torch.models import attention as ATT
from repro_torch.models import ssm as SSM
from repro_torch.models.config import check_supported
from repro_torch.models.layers import MLP, Norm, apply_norm
from repro_torch.models.moe import MoE, moe_ffn


class Block(nn.Module):
    def __init__(self, cfg, device, dtype):
        super().__init__()
        self.ln1 = Norm(cfg, device, dtype)
        self.attn = ATT.Attention(cfg, device, dtype)
        self.ln2 = Norm(cfg, device, dtype)
        if cfg.family == "moe":
            self.moe = MoE(cfg, device, dtype)
        else:
            self.mlp = MLP(cfg, device, dtype)


class DecBlock(nn.Module):
    """A Whisper decoder block: self-attention, cross-attention, MLP."""

    def __init__(self, cfg, device, dtype):
        super().__init__()
        self.ln1 = Norm(cfg, device, dtype)
        self.attn = ATT.Attention(cfg, device, dtype)
        self.ln2 = Norm(cfg, device, dtype)
        self.cross = ATT.Attention(cfg, device, dtype)
        self.ln3 = Norm(cfg, device, dtype)
        self.mlp = MLP(cfg, device, dtype)


class SSMBlock(nn.Module):
    def __init__(self, cfg, device, dtype):
        super().__init__()
        self.ln1 = Norm(cfg, device, dtype)
        self.mixer = SSM.Mamba2(cfg, device, dtype)


class LM(nn.Module):
    """Parameters of a decoder: `embed` (Vp, d), `layers`, `final_norm`,
    `lm_head` (an `nn.Linear`, weight (Vp, d)); for the hybrid family
    `shared`, its one attention block; for encdec `enc_layers`,
    `enc_norm` and `dec_pos` (DEC_POSITIONS, d). Every parameter is in the
    model dtype but a moe block's router and a Mamba-2 mixer's `A_log`,
    `dt_bias` and `D`, which are f32."""

    def __init__(self, cfg, device):
        super().__init__()
        check_supported(cfg)
        dtype = getattr(torch, cfg.dtype)
        vp, d = cfg.padded_vocab, cfg.d_model
        self.embed = nn.Parameter(torch.empty(vp, d, device=device,
                                              dtype=dtype))
        block = {"ssm": SSMBlock, "hybrid": SSMBlock,
                 "encdec": DecBlock}.get(cfg.family, Block)
        self.layers = nn.ModuleList(block(cfg, device, dtype)
                                    for _ in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared = Block(cfg, device, dtype)
        if cfg.family == "encdec":
            self.enc_layers = nn.ModuleList(
                Block(cfg, device, dtype) for _ in range(cfg.encoder_layers))
            self.enc_norm = Norm(cfg, device, dtype)
            self.dec_pos = nn.Parameter(torch.empty(
                DEC_POSITIONS, d, device=device, dtype=dtype))
        self.final_norm = Norm(cfg, device, dtype)
        self.lm_head = nn.Linear(d, vp, bias=False, device=device,
                                 dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.embed.device


# parameters set to a constant, by leaf name: norms (`w`, a mixer's
# `out_norm`) 1, biases (a LayerNorm's `b` too) 0, a mixer's skip `D` 1
CONSTANT = {"w": 1.0, "b": 0.0, "bias": 0.0, "conv_b": 0.0,
            "dt_bias": 0.0, "D": 1.0, "out_norm": 1.0}
# normal draws with a scale of their own, by name (others x d_in^-0.5)
SCALE = {"embed": 0.02, "dec_pos": 0.01}


def init_params(cfg, generator: torch.Generator | int, device=None) -> LM:
    """Random weights with the reference's scales (normal; `SCALE`:
    embeddings x0.02, Whisper's decoder positions x0.01; projections
    x d_in^-0.5, a mixer's conv_w x K^-0.5; `CONSTANT`
    leaves; a mixer's A_log = log(linspace(1, 16, H))), drawn from an
    explicit generator (a seed makes one on the device). The numbers are
    not the reference's: its `jax.random` draws differ. d_in is an
    `nn.Linear` weight's last dimension; a moe or mixer tensor is stored
    for `x @ W`, (.., d_in, d_out), so its d_in is the one before (for
    conv_w (K, Ch), K)."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device).manual_seed(generator)
    with torch.no_grad():
        model = LM(cfg, device)
        for name, t in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in CONSTANT:
                t.fill_(CONSTANT[leaf])
            elif leaf == "A_log":
                t.copy_(torch.log(torch.linspace(1.0, 16.0, t.numel())))
            else:
                t.normal_(generator=generator)
                stored_for_x_at_w = ".moe." in name or ".mixer." in name
                d_in = t.shape[-2] if stored_for_x_at_w else t.shape[-1]
                t.mul_(SCALE.get(name, d_in ** -0.5))
    return model.requires_grad_(False)


def param_count(model) -> int:
    """Parameter elements of an `LM` (or a dict of tensors), the padded
    vocabulary's rows and columns included, as the reference counts its
    tree's."""
    tensors = (model.values() if isinstance(model, dict)
               else model.parameters())
    return sum(t.numel() for t in tensors)


def _records_grad(model: LM) -> bool:
    """Whether autograd records a forward of `model`: grad mode on and a
    parameter that requires grad."""
    return torch.is_grad_enabled() and any(p.requires_grad
                                           for p in model.parameters())


def _layer(train: bool, fn, *args):
    """One layer's function; when training, as a checkpoint whose
    activations are recomputed in the backward (the reference's
    `jax.checkpoint` on its scan body). The layers draw no random
    numbers, so no RNG state is kept."""
    if train:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _lookup_rows(table, tokens):
    """`table[tokens]` on a mesh, per rank: each rank looks its token rows
    (batch-sharded tokens keep that layout, others are gathered) up in
    its own rows of the vocab-sharded table, zero where a token lies
    outside them, and the partial rows are summed over the table's axes.
    (DTensor's own indexing and embedding rules each miss a case of this
    on some torch release.)"""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = table.device_mesh
    if not RT.is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    t_place = [p if p == Shard(0) else Replicate() for p in tokens.placements]
    tok = tokens.redistribute(mesh, t_place).to_local()
    # each rank looks up its own token rows: the gradient of its table
    # rows sums over the batch's axes
    rows = RT.grad_sum(table.to_local(), [
        n for n, t in zip(mesh.mesh_dim_names, t_place) if t != Replicate()])
    _, offset = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)
    loc = tok.long() - offset[0]
    ok = (loc >= 0) & (loc < rows.shape[0])
    x = torch.where(ok[..., None], rows[loc.clamp(0, rows.shape[0] - 1)], 0)
    split = [n for n, p in zip(mesh.mesh_dim_names, table.placements)
             if isinstance(p, Shard)]
    if any(t != Replicate() for n, t in zip(mesh.mesh_dim_names, t_place)
           if n in split):
        raise ValueError("tokens and table rows sharded over one mesh axis")
    return DTensor.from_local(RT.psum(x, split), mesh, t_place,
                              run_check=False)


def _embed(cfg, model: LM, tokens: torch.Tensor) -> torch.Tensor:
    if RT.is_dtensor(model.embed):
        x = _lookup_rows(model.embed, tokens)
    else:
        x = model.embed[tokens]
    if cfg.embed_scale:
        # the scale rounds to the activation dtype first, as in jnp
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _positions(batch: dict, b: int, s: int, device) -> torch.Tensor:
    pos = batch.get("positions")
    if pos is None:
        return torch.arange(s, device=device)[None, :].expand(b, s)
    return torch.as_tensor(pos, device=device)


def _positions3(batch: dict, device) -> torch.Tensor | None:
    """M-RoPE's (t, h, w) position streams (3, B, S), or None."""
    pos3 = batch.get("positions3")
    return None if pos3 is None else torch.as_tensor(pos3, device=device)


DEC_POSITIONS = 448             # Whisper's learned decoder positions


def _sinusoid(seq: int, d: int, device) -> torch.Tensor:
    """(seq, d) f32: sines then cosines, the reference's `_sinusoid`."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _dec_positions(cfg, model: LM, s: int) -> torch.Tensor:
    """Whisper's learned decoder positions for s tokens (s, d): the table,
    extended past its DEC_POSITIONS entries by a sinusoid, as the
    reference's forward does (its decode step clamps to the last entry
    instead; the port copies both)."""
    table = model.dec_pos
    if s <= table.shape[0]:
        return table[:s]
    ext = _sinusoid(s - table.shape[0], cfg.d_model, table.device)
    return torch.cat([table, ext.to(table.dtype)])


def _encode(cfg, model: LM, frames) -> torch.Tensor:
    """Whisper's encoder over stubbed frame embeddings (B, T, d), which
    must be in the model dtype (an `nn.Linear` takes no other): the
    sinusoid added, bidirectional blocks, then `enc_norm`."""
    frames = torch.as_tensor(frames, device=model.device)
    if frames.dtype != model.embed.dtype:
        raise TypeError(f"frames in {frames.dtype}; the model's dtype "
                        f"{model.embed.dtype} expected")
    t = frames.shape[1]
    x = frames + _sinusoid(t, cfg.d_model, frames.device).to(frames.dtype)
    train = _records_grad(model)
    for lp in model.enc_layers:
        x = _layer(train, lambda x, lp=lp: _block_fwd(cfg, lp, x, None,
                                                      causal=False)[0], x)
    return apply_norm(cfg, model.enc_norm, x)


def _ffn_residual(cfg, lp: Block, x):
    """-> (x + the block's FFN of x, its auxiliary loss: the router's
    load-balancing loss for a moe block, None for a dense one). On a mesh,
    a batch that |DP| does not divide is replicated first: DTensor's
    products would otherwise shard the flattened rows over DP and then
    fail to unflatten them into the batch."""
    if RT.is_dtensor(x) and x.shape[0] % RT.dp_size():
        x = RT.constrain(x, None, None, None)
    h = apply_norm(cfg, lp.ln2, x)
    if cfg.family == "moe":
        y, aux = moe_ffn(cfg, lp.moe, h)
        return x + y, aux
    return x + lp.mlp(h), None


def _block_fwd(cfg, lp: Block, x, positions, positions3=None,
               causal: bool = True):
    """-> (x after the block, its auxiliary loss or None, the k and v its
    attention cached)."""
    a, k, v = ATT.self_attention(cfg, lp.attn, apply_norm(cfg, lp.ln1, x),
                                 positions, causal=causal,
                                 positions3=positions3)
    x, aux = _ffn_residual(cfg, lp, x + a)
    return x, aux, k, v


def _dec_block_fwd(cfg, lp: DecBlock, x, enc_h):
    """A Whisper decoder block over the whole sequence -> (x after it,
    its self-attention's k and v, the encoder K/V of its
    cross-attention)."""
    a, k, v = ATT.self_attention(cfg, lp.attn, apply_norm(cfg, lp.ln1, x),
                                 None)
    x = x + a
    h = apply_norm(cfg, lp.ln2, x)
    ek, ev = ATT.project_enc_kv(cfg, lp.cross, enc_h)
    x = x + ATT.cross_attention(cfg, lp.cross, h, ek, ev)
    return x + lp.mlp(apply_norm(cfg, lp.ln3, x)), k, v, ek, ev


def n_attention(cfg) -> int:
    """Self-attention calls a decode step makes, each on its own slot of
    the stacked KV cache: one a layer (dense, moe, vlm; encdec, whose
    decoder layers each add a cross-attention over the encoder's K/V),
    one an application of the shared block (hybrid: max(1, L // every)),
    none (ssm)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return max(1, cfg.n_layers // cfg.shared_attn_every)
    return cfg.n_layers


def kv_stack(cfg, caches: dict) -> dict | None:
    """The stacked KV cache (dense k/v or the tiered leaves, leading axis
    `n_attention(cfg)`) inside a family's caches: the caches themselves
    (dense, moe, vlm, encdec), their `shared` dict (hybrid), None
    (ssm)."""
    if cfg.family == "ssm":
        return None
    return caches["shared"] if cfg.family == "hybrid" else caches


def with_kv_stack(cfg, caches: dict, stack: dict) -> dict:
    """`caches` with its stacked KV cache replaced by `stack`."""
    if cfg.family == "hybrid":
        return dict(caches, shared=stack)
    return dict(caches, **stack)


def _is_application(cfg, li: int) -> bool:
    """Whether the hybrid's shared block runs after ssm block `li`."""
    every = cfg.shared_attn_every
    return cfg.family == "hybrid" and li % every == every - 1


def _stack(cfg, model: LM, batch: dict, caches: dict | None):
    """The layers over `batch["tokens"]` -> (hidden after the final norm,
    aux summed over the layers); with dense `caches` of the prompt's
    length, each attention's k and v land in its slot of the stacked KV
    cache, each ssm layer's decode state in caches["ssm"][i] and
    caches["conv"][i], and each decoder layer's encoder K/V in
    caches["enc_k"][i] and caches["enc_v"][i]."""
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    b, s = tokens.shape
    positions = _positions(batch, b, s, model.device)
    positions3 = _positions3(batch, model.device)
    x = _embed(cfg, model, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stack = None if caches is None else kv_stack(cfg, caches)
    if cfg.family == "encdec":
        enc_h = _encode(cfg, model, batch["frames"])
        x = x + _dec_positions(cfg, model, s)

    def attend(lp, x, j):
        x, a, k, v = _block_fwd(cfg, lp, x, positions, positions3)
        if stack is not None:
            stack["k"][j], stack["v"][j] = k, v
        return x, a

    def ssm_layer(i, lp, x):
        h = apply_norm(cfg, lp.ln1, x)
        if caches is None:
            x = x + SSM.mamba2_forward(cfg, lp.mixer, h)
        else:
            y, st = SSM.mamba2_prefill(cfg, lp.mixer, h)
            x = x + y
            caches["ssm"][i], caches["conv"][i] = st["ssm"], st["conv"]
        if _is_application(cfg, i):
            # the shared block's K/V only where it runs (the reference
            # computes them after every layer and keeps these); under
            # autograd its parameters gather a gradient an application
            x, _ = attend(model.shared, x, i // cfg.shared_attn_every)
        return x

    def dec_layer(i, lp, x, enc_h):
        x, k, v, ek, ev = _dec_block_fwd(cfg, lp, x, enc_h)
        if caches is not None:
            stack["k"][i], stack["v"][i] = k, v
            caches["enc_k"][i], caches["enc_v"][i] = ek, ev
        return x

    train = _records_grad(model)
    for i, lp in enumerate(model.layers):
        if isinstance(lp, SSMBlock):
            x = _layer(train, ssm_layer, i, lp, x)
        elif isinstance(lp, DecBlock):
            x = _layer(train, dec_layer, i, lp, x, enc_h)
        else:
            x, a = _layer(train, attend, lp, x, i)
            if a is not None:
                aux = aux + a
    return apply_norm(cfg, model.final_norm, x), aux


def _stack_spmd(cfg, model: LM, batch: dict, caches: dict | None):
    """`_stack` in `RT.spmd()`: on DTensor parameters (a mesh registered)
    the plain tensors it makes (positions, masks) join as replicated."""
    with RT.spmd():
        return _stack(cfg, model, batch, caches)


def forward(cfg, model: LM, batch: dict):
    """-> (hidden (B, S, d), aux_loss f32 scalar summed over the layers).
    When autograd records (grad mode on, a parameter that requires grad)
    each layer is a checkpoint, so the backward holds one layer's
    activations at a time beside each layer's input; the hybrid's
    shared block gets the sum of its applications' gradients."""
    return _stack_spmd(cfg, model, batch, None)


@torch.no_grad()
def forward_collect(cfg, model: LM, batch: dict):
    """Prefill: -> (hidden (B, S, d), dense caches ready for
    `decode_step`: {"k", "v" (L, B, S, KV, hd)} for dense, moe and vlm,
    and for encdec with "enc_k", "enc_v" (L, B, T, KV, hd) beside them;
    {"ssm" (L, B, H, P, N) f32, "conv" (L, B, K-1, Ch)} for ssm, and
    both for hybrid with the K/V under "shared" (one slot an
    application); and "pos" (B,))."""
    b, s = torch.as_tensor(batch["tokens"]).shape
    t = batch["frames"].shape[1] if cfg.family == "encdec" else None
    if RT.is_dtensor(model.embed):
        caches = _mesh_caches(cfg, b, s, t, model.embed.device_mesh)
    else:
        caches = init_decode_caches(cfg, b, s, "dense", model.device,
                                    enc_len=t)
    hidden, _ = _stack_spmd(cfg, model, batch, caches)
    caches["pos"].fill_(s)
    return hidden, caches


def _mesh_caches(cfg, b: int, s: int, t, mesh) -> dict:
    """Zeroed dense caches as DTensors laid out by the sharding rules
    (`cache_pspecs`), each rank making only its own shards."""
    from torch.distributed.tensor import zeros as dzeros

    from repro_torch.distributed import sharding as SH
    meta = init_decode_caches(cfg, b, s, "dense", "meta", enc_len=t)

    def make(tree, specs):
        return {k: make(v, specs[k]) if isinstance(v, dict) else
                dzeros(v.shape, dtype=v.dtype, device_mesh=mesh,
                       placements=SH.placements(mesh, specs[k]))
                for k, v in tree.items()}
    return make(meta, SH.cache_pspecs(cfg, meta, mesh))


def prefill_step(cfg, model: LM, batch: dict):
    """-> (last-token logits (B, vocab), dense caches)."""
    hidden, caches = forward_collect(cfg, model, batch)
    with torch.no_grad():
        logits = model.lm_head(hidden[:, -1, :])[..., :cfg.vocab]
    return logits, caches


@torch.no_grad()
def logits_full(cfg, model: LM, batch: dict) -> torch.Tensor:
    """Small-model convenience: full (B, S, vocab) logits."""
    hidden, _ = forward(cfg, model, batch)
    with RT.spmd():
        return model.lm_head(hidden)[..., :cfg.vocab]


def init_decode_caches(cfg, batch: int, max_len: int, kind: str = "dense",
                       device=None, enc_len: int | None = None) -> dict:
    """Zeroed decode state. kind: dense | lsm. The stacked KV cache
    (`kv_stack`) has n_attention(cfg) slots; ssm and hybrid add each
    layer's `ssm` (f32) and `conv` state, encdec each decoder layer's
    encoder K/V `enc_k`/`enc_v` of `enc_len` positions (cfg.encoder_seq
    unless given). An ssm model has no KV cache and takes either kind,
    as in the reference; an encdec model's dense layout is its only one
    (its decoder is bounded at DEC_POSITIONS), for either kind, as in
    the reference."""
    check_supported(cfg)
    if kind not in ("dense", "lsm"):
        raise ValueError(f"cache kind {kind!r}: dense | lsm")
    device = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    out = {}
    if cfg.family in ("ssm", "hybrid"):
        out = {k: torch.zeros((cfg.n_layers,) + s, dtype=d, device=device)
               for k, (s, d) in SSM.mamba2_decode_state_shapes(
                   cfg, batch).items()}
    if cfg.family == "encdec":
        shape = (cfg.n_layers, batch, enc_len or cfg.encoder_seq, cfg.n_kv,
                 cfg.hd)
        out = {k: torch.zeros(shape, dtype=dt, device=device)
               for k in ("enc_k", "enc_v")}
    if cfg.family != "ssm":
        n = n_attention(cfg)
        if kind == "lsm" and cfg.family != "encdec":
            stack = {k: torch.zeros((n,) + s, dtype=d, device=device)
                     for k, (s, d) in ATT.lsm_cache_shapes(cfg, batch,
                                                           max_len).items()}
        else:
            shape = (n, batch, max_len, cfg.n_kv, cfg.hd)
            stack = {"k": torch.zeros(shape, dtype=dt, device=device),
                     "v": torch.zeros(shape, dtype=dt, device=device)}
        out = with_kv_stack(cfg, out, stack)
    out["pos"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return out


@torch.no_grad()
def decode_step(cfg, model: LM, token: torch.Tensor, caches: dict,
                kind: str = "dense"):
    """token (B,) int -> (logits (B, vocab), caches). The cache tensors
    are updated in place; the returned dict holds the new counters. Each
    attention call writes its slot of the stacked KV cache at a position
    read to the host once a step. An encdec model decodes its dense
    layout whatever `kind` says, as the reference does. On DTensor
    parameters and caches (a mesh registered) it runs in `RT.spmd()`."""
    if kind not in ("dense", "lsm"):
        raise ValueError(f"cache kind {kind!r}: dense | lsm")
    with RT.spmd():
        return _decode_step(cfg, model, token, caches, kind)


def _decode_step(cfg, model: LM, token, caches: dict, kind: str):
    pos = caches["pos"]
    x = _embed(cfg, model, torch.as_tensor(token, device=model.device))
    x = x[:, None, :]                                       # (B, 1, d)
    if cfg.family == "encdec":   # one layout; past the table its last entry
        kind = "dense"
        table = model.dec_pos
        x = x + table[pos.clamp(max=table.shape[0] - 1).long()][:, None, :]
    stack = kv_stack(cfg, caches)
    if stack is not None:
        # in a shape-only run the slots read as 0, a slot every cache has
        # (no shape of the step depends on them)
        where = (shape_only.host_ints(stack["hot_len"][:, 0])
                 if kind == "lsm"
                 else shape_only.host_ints(pos[:1]) * n_attention(cfg))
    hot_len = []

    def attend(lp, x, j):
        """Attention block `lp` on slot j of the stacked KV cache."""
        h = apply_norm(cfg, lp.ln1, x)
        if kind == "lsm":
            lcache = {k: stack[k][j] for k in ATT.LSM_KEYS}
            a, lcache = ATT.lsm_decode_self_attention(cfg, lp.attn, h,
                                                      lcache, pos, where[j])
            hot_len.append(lcache["hot_len"])
        else:
            a = ATT.decode_self_attention(cfg, lp.attn, h, stack["k"][j],
                                          stack["v"][j], pos, where[j])
        return _ffn_residual(cfg, lp, x + a)[0]

    for i, lp in enumerate(model.layers):
        if isinstance(lp, SSMBlock):
            state = {"ssm": caches["ssm"][i], "conv": caches["conv"][i]}
            x = x + SSM.mamba2_decode(cfg, lp.mixer,
                                      apply_norm(cfg, lp.ln1, x), state)
            if _is_application(cfg, i):
                x = attend(model.shared, x, i // cfg.shared_attn_every)
        elif isinstance(lp, DecBlock):
            x = x + ATT.decode_self_attention(
                cfg, lp.attn, apply_norm(cfg, lp.ln1, x), stack["k"][i],
                stack["v"][i], pos, where[i])
            x = x + ATT.decode_cross_attention(
                cfg, lp.cross, apply_norm(cfg, lp.ln2, x), caches["enc_k"][i],
                caches["enc_v"][i])
            x = x + lp.mlp(apply_norm(cfg, lp.ln3, x))
        else:
            x = attend(lp, x, i)
    if hot_len:
        caches = with_kv_stack(cfg, caches,
                               dict(stack, hot_len=torch.stack(hot_len)))
    x = apply_norm(cfg, model.final_norm, x)
    logits = model.lm_head(x[:, 0, :])[..., :cfg.vocab]
    return logits, dict(caches, pos=pos + 1)
