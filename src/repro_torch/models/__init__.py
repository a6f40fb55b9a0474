"""The LM stack on PyTorch (port of `repro.models`, dense family).

  config.py    — `ModelConfig` and `pad_vocab` (own copy)
  layers.py    — RMSNorm, RoPE, gated MLPs
  attention.py — prefill attention, dense and sLSM-tiered decode
  lm.py        — parameters, prefill, decode steps, full logits
"""
