"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
`repro.models.moe`).

Tokens are routed by a sorted permutation, so no expert has a dynamic
shape: each expert runs a dense (E, C, d) x (E, d, f) batched product
over its C capacity slots, and the results scatter-add back through the
same permutation. The products are `torch.bmm`, as the reference's are
`einsum` outside any Pallas kernel.

Two paths, taken where the reference takes them: with a mesh
registered (`distributed.runtime`), the batch divisible by |DP| and the
experts by |model|, the mesh path (`_moe_mesh`, the reference's
`_moe_shard_map`): each rank routes its own batch rows through its own
slice of the experts, and the expert outputs are summed over the model
axis; otherwise the grouped path over `cfg.moe_dp_groups` token groups.

Parameters keep the reference's leaves and layouts, for `x @ W`: router
(d, E) in f32, w_gate and w_up (E, d, f), w_down (E, f, d) in the model
dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import runtime as RT


class MoE(nn.Module):
    def __init__(self, cfg, device, dtype):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dt))

        self.router = param(d, e, dt=torch.float32)
        self.w_gate = param(e, d, f)
        self.w_up = param(e, d, f)
        self.w_down = param(e, f, d)


def moe_capacity(cfg, tokens: int) -> int:
    """Slots an expert takes from a group of `tokens` tokens: the
    expected share times `capacity_factor`, rounded up to 8, at least 8."""
    cap = int(tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, ((cap + 7) // 8) * 8)


def _route(cfg, router: torch.Tensor, xt: torch.Tensor):
    """The router over a token group (T, d): -> (probs (T, E) f32, the
    top-k probabilities and their experts (T, k), largest first)."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.moe_top_k, dim=-1)
    return probs, top_p, top_e


def _dispatch(cfg, router, w_gate, w_up, w_down, xt: torch.Tensor, c: int,
              e0: int = 0):
    """Route one token group (T, d) at capacity `c` through the experts
    e0 .. e0 + El - 1, whose stacks are w_gate/w_up (El, d, f) and
    w_down (El, f, d) (El = E on one device). Returns (y (T, d) f32,
    the part those experts add; aux f32 scalar over all E experts)."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    dev = xt.device

    probs, top_p, top_e = _route(cfg, router, xt)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balancing auxiliary loss (Switch-style)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, top_e.reshape(-1),
        torch.full((t * k,), 1.0 / (t * k), dtype=torch.float32, device=dev))
    aux = e * (probs.mean(dim=0) * ce).sum()

    # token-expert pairs sorted by expert; a stable sort, as jnp.argsort,
    # so capacity drops keep the same pairs
    flat_e = top_e.reshape(-1)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], top_p.reshape(-1)[order]

    # each expert's contiguous slots (capacity c, overflow dropped); an
    # empty slot gathers token 0 and carries weight 0
    eid = e0 + torch.arange(w_gate.shape[0], device=dev)
    lo = torch.searchsorted(se, eid)
    hi = torch.searchsorted(se, eid, right=True)
    slot = lo[:, None] + torch.arange(c, device=dev)[None, :]
    valid = slot < hi[:, None]                               # (El, C)
    slot_c = slot.clamp(0, t * k - 1)
    tok = torch.where(valid, st[slot_c], 0)                  # (El, C)
    wgt = torch.where(valid, sw[slot_c], 0.0)

    xe = xt[tok] * valid[..., None].to(xt.dtype)             # (El, C, d)
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down)                                # (El, C, d)
    y = torch.zeros((t, d), dtype=torch.float32, device=dev).index_add_(
        0, tok.reshape(-1), (ye.float() * wgt[..., None]).reshape(-1, d))
    return y, aux


def _dispatch_local(cfg, p: MoE, xt: torch.Tensor, c: int):
    """Route one token group (T, d) through every expert at capacity
    `c`. Returns (y (T, d) f32, aux f32 scalar)."""
    return _dispatch(cfg, p.router, p.w_gate, p.w_up, p.w_down, xt, c)


def _moe_mesh(cfg, p: MoE, x: torch.Tensor):
    """The mesh path (the reference's `_moe_shard_map`): routing, sort,
    gather, expert products and combine are all rank-local; the only
    collectives are the sum of the expert outputs over the model axis
    and the mean of aux over DP. Each rank takes its batch rows
    (B / |DP|; capacity from its own T_local tokens) and its expert
    slice e0 = model_rank * E / |model| of the stacks (laid out
    `Shard(0)` over `model`), through `to_local()`. The router runs on
    every model rank. x and the weights may be DTensors or full tensors
    on every rank; the result is a DTensor (batch over DP) for a
    DTensor x, else the full tensors. A batch that |DP| does not divide
    (a DTensor x only: decode at batch 1) is whole on every DP rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = RT.mesh()
    names = mesh.mesh_dim_names
    dp, model = RT.dp_axes(), RT.model_axis()
    b, s, d = x.shape
    split = b % RT.dp_size() == 0           # batch rows over DP
    rows_dp = dp if split else ()
    bl = b // RT.dp_size() if split else b
    c = moe_capacity(cfg, bl * s)
    e_local = cfg.n_experts // RT.model_size()

    def dt(t):
        return t if RT.is_dtensor(t) else DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False)

    # each rank's part: its rows of x (whose gradient sums over the
    # expert slices), the router (over its rows and slices), its expert
    # slice (over the rows)
    x_l = RT.grad_sum(RT.constrain(dt(x), "dp" if split else None, None,
                                   None).to_local(), model)    # (Bl, S, d)
    router = RT.grad_sum(RT.constrain(dt(p.router), None, None).to_local(),
                         (*rows_dp, model))
    w = [RT.grad_sum(RT.constrain(dt(t), "model", None, None).to_local(),
                     rows_dp)
         for t in (p.w_gate, p.w_up, p.w_down)]                # (El, ., .)
    e0 = RT.axis_rank(model) * e_local
    y, aux = _dispatch(cfg, router, *w, x_l.reshape(bl * s, d), c, e0)
    y = RT.psum(y.reshape(bl, s, d), model).to(x.dtype)   # over experts
    # aux is the same on every expert slice: a 1/|model| share of it from
    # each keeps its gradient a sum of parts too; then the mean over DP
    aux = RT.psum(aux / RT.model_size(), (model, *dp)) / RT.dp_size()
    y = DTensor.from_local(y, mesh, [Shard(0) if n in rows_dp
                                     else Replicate() for n in names],
                           run_check=False)
    aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    if RT.is_dtensor(x):
        return y, aux
    return y.full_tensor(), aux.full_tensor()


def moe_ffn(cfg, p: MoE, x: torch.Tensor):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux_loss f32 scalar).

    With a mesh registered, B divisible by |DP| (or x a DTensor) and the
    experts by |model|: the mesh path (`_moe_mesh`). Otherwise the tokens
    split into G = min(moe_dp_groups, B) groups, each routed on its own at the
    capacity of T / G tokens; aux is the groups' mean. Capacity is per
    group or shard, so with no overflow the paths compute the same
    function."""
    b, s, d = x.shape
    if (RT.mesh() is not None and (b % RT.dp_size() == 0
                                   or RT.is_dtensor(x))
            and cfg.n_experts % RT.model_size() == 0):
        return _moe_mesh(cfg, p, x)
    t = b * s
    g = max(1, min(cfg.moe_dp_groups, b))     # cannot split below 1 batch row
    c = moe_capacity(cfg, t // g)
    ys, auxs = zip(*(_dispatch_local(cfg, p, xt, c)
                     for xt in x.reshape(g, t // g, d)))
    return (torch.stack(ys).reshape(b, s, d).to(x.dtype),
            torch.stack(auxs).mean())
