"""Parameters, Bloom filters, sorted-run primitives and the dict oracle."""
