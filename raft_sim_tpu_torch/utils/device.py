"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """The torch.device an entry point runs on. The default is the card; with
    no card present that raises -- nothing drops to the CPU unless the caller
    asks for it (the tests pass device="cpu")."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
