"""Hand-written CUDA kernels of the port, one package each.

Every package holds a plain PyTorch version of its function and a
wrapper that launches the CUDA kernel from `repro_torch/csrc/` for CUDA
tensors (counting its launches) and runs the plain version for CPU
tensors:

  bloom_probe  — Bloom membership over every level's filters (paper 2.3)
  fence_lookup — fence-pointer page search over a level's D runs (2.4)
  heap_merge   — the k-way run merge, and one tournament round (2.5)
  range_merge  — the range scan's per-row segment merge-dedup (2.9)
  lsm_attention — single-token GQA decode attention over the sLSM-tiered
                 (or dense) KV cache, for the LM serving path

`_build` compiles the sources with nvcc at first use.
"""
