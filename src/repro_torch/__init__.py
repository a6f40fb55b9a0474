"""sLSM key-value engine on PyTorch and CUDA (port of `repro`).

The package mirrors the JAX reference `repro` module by module and gives
bitwise-equal answers. It imports neither JAX nor `repro`. Porting traps
met along the way, each named in a comment where its fix lands:

  T1  uint32 arithmetic: torch's uint32 tensors lack `>>`, `%` and `+`;
      hashing runs in int64 masked to 32 bits (CUDA: native uint32_t).
  T2  two-key sort: `lax.sort(num_keys=2)` is one stable sort of the
      int64 `(key << 32) | seq`.
  T3  int32 reductions: a torch sum of int32 is int64; counts and sums
      come back as int32 with wraparound.
  T4  out-of-range indices: JAX drops or clamps them, torch raises (or
      faults on CUDA); every such scatter/slice is clamped or given a
      spare slot explicitly.
  T5  `lax.cond`: a data-dependent skip becomes a `torch.where`.
  T6  Bloom filters: uint32 words in the reference, int32 words holding
      the same bits here.
  T7  device memory: the paper geometry's deepest level (323,584,000
      slots a run) does not fit a card; runs stay at two levels there.
"""
