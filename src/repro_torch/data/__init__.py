"""Data: the synthetic token stream (port of `repro.data`)."""
from repro_torch.data.pipeline import TokenStream  # noqa: F401
