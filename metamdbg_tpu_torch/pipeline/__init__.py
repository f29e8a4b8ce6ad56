"""The subcommands: `asm` (pipeline/asm.py), `gfa` (pipeline/gfa.py) and
`map` (pipeline/mapref.py)."""

import torch


def open_device(device) -> torch.device:
    """The device a subcommand runs on, checked at startup: `cuda` needs a
    usable NVIDIA GPU and raises without one; `cpu` runs the kernels' plain
    torch versions."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is "
                           "False (no usable NVIDIA GPU); use --device "
                           "cpu to run the plain torch versions")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
