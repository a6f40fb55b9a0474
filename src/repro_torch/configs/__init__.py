"""Configurations: the engine's paper baseline (`slsm_paper`) and the LM
registry (`get_config`), the port's copy of `repro.configs`.

The registry holds every architecture the reference registers, of the
families `dense`, `moe`, `ssm`, `hybrid`, `encdec` and `vlm`.
"""
from __future__ import annotations

import importlib

DENSE_ARCHS = ["phi4_mini_3_8b", "qwen1_5_4b", "deepseek_7b", "gemma_7b"]
MOE_ARCHS = ["granite_moe_1b_a400m", "qwen3_moe_30b_a3b"]
SSM_ARCHS = ["mamba2_370m"]
HYBRID_ARCHS = ["zamba2_1_2b"]
ENCDEC_ARCHS = ["whisper_tiny"]
VLM_ARCHS = ["qwen2_vl_7b"]
ARCHS = (DENSE_ARCHS + MOE_ARCHS + SSM_ARCHS + HYBRID_ARCHS + ENCDEC_ARCHS
         + VLM_ARCHS)

ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES.update({"phi4-mini-3.8b": "phi4_mini_3_8b",
                "qwen1.5-4b": "qwen1_5_4b"})


def get_config(arch: str):
    """The `ModelConfig` of a registered architecture id (hyphens or
    module name)."""
    mod_name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if mod_name not in ARCHS:
        raise KeyError(f"unknown architecture {arch!r}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def all_arch_ids() -> list[str]:
    """The architectures the port runs, by hyphenated id."""
    return [a.replace("_", "-") for a in ARCHS]
