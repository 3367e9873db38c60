"""Device selection for the port's entry points.

Every entry point takes an explicit `device` that defaults to "cuda":
the port is written for the card, and the CPU is used only when a
caller asks for it (the CPU parity tests do). There is no silent
fallback from CUDA to the CPU.
"""

import torch


def resolve_device(device="cuda"):
    """`device` -> torch.device, raising when CUDA is asked for on a
    machine that has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch twins "
            "on the CPU")
    return dev
