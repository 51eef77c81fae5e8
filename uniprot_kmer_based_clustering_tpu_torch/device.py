"""Device selection: an explicit device, never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(name="cuda") -> torch.device:
    """``"cuda"``/``"cuda:N"`` or ``"cpu"`` → a concrete torch device.

    Asking for CUDA on a machine without a visible GPU raises: the port
    never carries on on the CPU unless the CPU was requested.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch sees no CUDA GPU; "
                "pass device='cpu' to run the plain versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
