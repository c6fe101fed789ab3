"""Where new state is put: on the GPU unless the caller names a device."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Without a GPU that raises: the package's
    entry points do not carry on on the CPU unless asked to."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=None means 'cuda', and no CUDA device is available; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
