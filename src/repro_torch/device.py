"""Where the port runs: the GPU unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; with no GPU present that raises rather than
    running somewhere the caller did not ask for. Pass ``"cpu"`` to run on
    the CPU (the parity tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no GPU is visible; "
                "pass device='cpu' (or --device cpu) to run on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no GPU is visible")
    return dev
