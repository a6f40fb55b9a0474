"""Whisper-tiny [arXiv:2212.04356].

4L enc + 4L dec, d_model=384 6H (kv=6) d_ff=1536 vocab=51865 — enc-dec.
The conv front end is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, 1500, d) in the model dtype and adds
sinusoidal positions. LayerNorm + GELU (not RMS/SwiGLU), learned decoder
positions (448 max).

The decoder is bounded at 448 positions by design, so its KV cache is
never tiered: `generate(kind="lsm")` raises for this family.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv=6,
    d_ff=1536, vocab=51865,
    act="gelu", norm="layernorm", rope=False,
    encoder_layers=4, encoder_seq=1500,
)
