"""Where the port runs: the CUDA card unless the caller asks otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``, and raises ``RuntimeError`` when no CUDA
    device is present: the port never drops to the CPU on its own.  Pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
