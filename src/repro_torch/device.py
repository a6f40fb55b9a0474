"""Where the port runs: on the CUDA card unless the caller asks for the
CPU."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`None` means the CUDA card; without one, raise — the CPU is used
    only when the caller asks for it. A CUDA device named explicitly
    raises the same way where there is no card."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass "
            "device='cpu' to run its plain PyTorch path on the CPU")
    return device
