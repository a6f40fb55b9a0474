"""Sequence-chunked cross-entropy (port of `repro.train.loss`).

The (B, S, V) logits tensor is never materialised: a loop over sequence
chunks computes logits for `chunk` positions at a time (B, chunk, Vp),
reduces them to the loss terms, and, when autograd records, runs each
chunk as a checkpoint that the backward recomputes (the reference's
`jax.checkpoint` on its scan body). So the backward holds one chunk's
logits at a time.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import runtime as RT

NEG_BIG = -1e30               # a padded vocabulary column's logit


def _pick_chunk(s: int, chunk: int) -> int:
    """Largest divisor of s that is <= chunk."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def _chunk_terms(h_c, y_c, lm_head, vocab: int):
    """One chunk -> (sum of -log p(label) over its valid labels, their
    count), both f32 scalars."""
    logits = (h_c @ lm_head).float()                      # (B, c, Vp)
    # on a mesh the vocab axis is model-sharded; the label gather has no
    # DTensor rule there, so the chunk's logits gather that axis first
    if RT.is_dtensor(logits):
        b = logits.shape[0]
        logits = RT.constrain(logits, "dp" if b % RT.dp_size() == 0
                              else None, None, None)
    col_ok = torch.arange(logits.shape[-1], device=logits.device) < vocab
    logits = torch.where(col_ok, logits, NEG_BIG)
    lse = torch.logsumexp(logits, dim=-1)                 # (B, c)
    ll = torch.gather(logits, -1, y_c.clamp_min(0)[..., None].long())[..., 0]
    valid = (y_c >= 0).float()
    return ((lse - ll) * valid).sum(), valid.sum()


def chunked_cross_entropy(hidden: torch.Tensor, lm_head: torch.Tensor,
                          labels: torch.Tensor, vocab: int,
                          chunk: int = 512) -> torch.Tensor:
    """hidden (B, S, d); lm_head (d, Vp) (an `LM`'s `lm_head.weight.T`);
    labels (B, S) integer, -1 = pad -> the mean f32 loss over the valid
    labels.

    Vocab padding columns (>= vocab) are excluded from the logsumexp.
    The chunks' sums add up in sequence order, as the reference's scan
    carries them.
    """
    b, s, _ = hidden.shape
    c = _pick_chunk(s, chunk)
    records = torch.is_grad_enabled() and (hidden.requires_grad
                                           or lm_head.requires_grad)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, c):
        args = (hidden[:, c0:c0 + c], labels[:, c0:c0 + c], lm_head, vocab)
        if records:
            terms = checkpoint(_chunk_terms, *args, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            terms = _chunk_terms(*args)
        loss_sum = loss_sum + terms[0]
        cnt = cnt + terms[1]
    return loss_sum / cnt.clamp_min(1.0)
