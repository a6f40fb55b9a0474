"""The LM stack on PyTorch (port of `repro.models`, every family: dense,
moe, ssm, hybrid, encdec and vlm).

  config.py    — `ModelConfig` and `pad_vocab` (own copy)
  layers.py    — RMSNorm, LayerNorm, RoPE, M-RoPE, gated and plain MLPs
  attention.py — prefill attention, dense and sLSM-tiered decode,
                 cross-attention
  moe.py       — the moe FFN: router, capacity dispatch, experts
  ssm.py       — the Mamba-2 mixer: chunked SSD, state decode
  lm.py        — parameters, forward, prefill, decode steps, full logits
"""
