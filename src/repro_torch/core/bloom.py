"""Bloom filters (paper 2.3) — Murmur3-style double hashing, on tensors.

Bit-identical to `repro.core.bloom`: same seeds, same finalizer, same
double-hash positions h1 + i*h2, same word layout. A filter is stored as
int32 words holding the reference's uint32 bits (trap T6: torch's uint32
tensors lack the arithmetic the hash needs; the CUDA kernel reads the
same words as `uint32_t`).

Trap T1 (uint32 arithmetic): the hash runs in int64 masked to 32 bits.
Every product is formed from 16-bit halves so no intermediate leaves the
int64 range, and h1 + i*h2 is reduced mod 2**32 before `% bits`.
"""
from __future__ import annotations

import torch

SEED1 = 0x9E3779B9
SEED2 = 0x85EBCA77

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): x = hi*2**16 + lo, and
    lo*c, hi*c are both < 2**48, so nothing overflows int64."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 32-bit finalizer over int64 lanes holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    x = x ^ (x >> 16)
    return x


def as_u32(keys: torch.Tensor) -> torch.Tensor:
    """int32 keys -> int64 lanes holding the same 32 bits as uint32."""
    return keys.to(torch.int64) & _M32


def probe_positions(keys: torch.Tensor, k: int, bits: int) -> torch.Tensor:
    """(..., k) int64 bit positions via double hashing (paper 2.3)."""
    u = as_u32(keys)
    h1 = fmix32(u ^ SEED1)
    h2 = fmix32(u ^ SEED2) | 1  # odd => full-period stride
    i = torch.arange(k, dtype=torch.int64, device=keys.device)
    pos = (h1[..., None] + i * h2[..., None]) & _M32   # mod 2**32 first
    return pos % bits


def words_to_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 lanes in [0, 2**32) -> int32 with the same bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def bloom_build(keys: torch.Tensor, valid: torch.Tensor, words: int, k: int,
                bits: int | None = None) -> torch.Tensor:
    """Build a (words,) int32 filter over `keys` where `valid`.

    `bits` is the effective filter size (default words*32). The
    positions are sorted and each word is the sum of its distinct bits
    (their OR), so memory follows the keys, not the filter's bits, and
    nothing waits on the device. Trap T4: the reference scatters invalid
    lanes to position words*32 and lets JAX drop them; here they land in
    a spare word that is cut off. The reference's positions are int32
    and it raises `OverflowError` at the first build of a filter of
    2**31 bits or more; so does the port, before it allocates anything."""
    if words * 32 >= 2 ** 31:
        raise OverflowError(f"bloom_build: a filter of {words} words holds "
                            f"{words * 32} bits, 2**31 or more")
    if bits is None:
        bits = words * 32
    assert bits <= words * 32, f"effective bits {bits} > {words} words"
    pos = torch.where(valid[..., None], probe_positions(keys, k, bits),
                      words * 32).reshape(-1)
    pos = torch.sort(pos).values
    first = torch.ones_like(pos, dtype=torch.bool)
    first[1:] = pos[1:] != pos[:-1]
    bit = torch.bitwise_left_shift(torch.ones_like(pos), pos % 32)
    packed = torch.zeros(words + 1, dtype=torch.int64, device=keys.device)
    packed.scatter_add_(0, pos // 32, torch.where(first, bit, 0))
    return words_to_i32(packed[:words])



def bloom_insert(filter_words: torch.Tensor, keys: torch.Tensor,
                 valid: torch.Tensor, k: int,
                 bits: int | None = None) -> torch.Tensor:
    """OR new keys into an existing (words,) int32 filter: a `bloom_build`
    of the same geometry, or'ed word by word (the int32 words hold the
    reference's uint32 bits, so the OR is the same)."""
    add = bloom_build(keys, valid, filter_words.shape[-1], k, bits)
    return filter_words | add

def bloom_probe(filter_words: torch.Tensor, keys: torch.Tensor, k: int,
                bits: int | None = None) -> torch.Tensor:
    """Membership test over a (words,) int32 filter: (...,) keys -> bool.
    No false negatives; false positives at rate ~eps."""
    if bits is None:
        bits = filter_words.shape[-1] * 32
    pos = probe_positions(keys, k, bits)
    w = filter_words[pos // 32].to(torch.int64)
    bit = (w >> (pos % 32)) & 1
    return torch.all(bit == 1, dim=-1)
