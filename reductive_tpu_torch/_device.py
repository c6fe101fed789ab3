"""Where new state is put: on the GPU unless the caller names a device."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "instances_on", "check_generator"]


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


def instances_on(instances, device=None) -> torch.Tensor:
    """The training instances as a tensor.  A tensor stays where it lies
    (``device`` must then be ``None`` or its own device); a host array is
    put on ``device``, where ``None`` means ``cuda``."""
    if isinstance(instances, torch.Tensor):
        if device is not None and torch.device(device).type != instances.device.type:
            raise ValueError(f"instances lie on {instances.device}, device={device!r} was asked for")
        return instances
    return torch.as_tensor(instances, device=resolve_device(device))


def check_generator(generator: torch.Generator, device: torch.device) -> None:
    """Random draws are made on the device of the data, so the generator
    must live there (``torch.Generator(device=...)``)."""
    if not isinstance(generator, torch.Generator):
        raise TypeError(f"expected a torch.Generator, got {type(generator).__name__}")
    if generator.device.type != device.type:
        raise ValueError(
            f"the generator lives on {generator.device}, the data on {device}: "
            f"make it with torch.Generator(device={device.type!r})"
        )
