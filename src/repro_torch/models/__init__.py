"""The LM stack on PyTorch (port of `repro.models`, dense and moe
families).

  config.py    — `ModelConfig` and `pad_vocab` (own copy)
  layers.py    — RMSNorm, RoPE, gated MLPs
  attention.py — prefill attention, dense and sLSM-tiered decode
  moe.py       — the moe FFN: router, capacity dispatch, experts
  lm.py        — parameters, forward, prefill, decode steps, full logits
"""
