"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  The CPU is
used only when the caller asks for it (the CPU tests do); nothing falls back
to it on its own, and asking for the card on a machine without one raises.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` (or a ``torch.device`` of that type) → the card, which
    must be present; ``"cpu"`` → the host, where kernels run their plain
    torch versions.  Anything else raises ``ValueError``."""
    try:
        dev = torch.device(device)
    except (RuntimeError, TypeError) as err:
        raise ValueError(f"unknown device {device!r}; expected 'cuda' or 'cpu'") from err
    if dev.type == "cpu":
        return dev
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain torch versions")
        return dev
    raise ValueError(f"unsupported device {device!r}; expected 'cuda' or 'cpu'")
