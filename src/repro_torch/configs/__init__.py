"""Configurations: the engine's paper baseline (`slsm_paper`) and the LM
registry (`get_config`), the port's copy of `repro.configs`.

The registry holds the dense-family configurations, the only family the
port runs. The reference's other assigned architectures are known by
id; asking for one raises `NotImplementedError` naming the slice that
will add it.
"""
from __future__ import annotations

import importlib

DENSE_ARCHS = ["phi4_mini_3_8b", "qwen1_5_4b", "deepseek_7b", "gemma_7b"]

# the reference's other assigned architectures -> the port slice adding them
LATER = {
    "qwen2-vl-7b": "vlm (M-RoPE)",
    "granite-moe-1b-a400m": "moe",
    "qwen3-moe-30b-a3b": "moe",
    "mamba2-370m": "ssm",
    "whisper-tiny": "encdec",
    "zamba2-1.2b": "hybrid",
}

ALIASES = {a.replace("_", "-"): a for a in DENSE_ARCHS}
ALIASES.update({"phi4-mini-3.8b": "phi4_mini_3_8b",
                "qwen1.5-4b": "qwen1_5_4b"})


def get_config(arch: str):
    """The `ModelConfig` of a registered architecture id (hyphens or
    module name)."""
    if arch in LATER:
        raise NotImplementedError(
            f"{arch}: the {LATER[arch]} slice of the port adds it "
            "(ROADMAP Queue A); this slice runs the dense family")
    mod_name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if mod_name not in DENSE_ARCHS:
        raise KeyError(f"unknown architecture {arch!r}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def all_arch_ids() -> list[str]:
    """The dense architectures the port runs, by hyphenated id."""
    return [a.replace("_", "-") for a in DENSE_ARCHS]
