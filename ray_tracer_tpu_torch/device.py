"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  With no
CUDA device and no explicit CPU request they raise: nothing falls back
to the CPU silently.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> cuda; "cpu" / "cuda" / "cuda:N" / torch.device as given.
    A CUDA request on a machine without CUDA raises RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def same_device(have: torch.device, want: torch.device) -> bool:
    """Does a tensor on `have` lie where `want` asks?  A cuda device
    without an index is the current card, as torch places it there."""
    if have.type != want.type:
        return False
    if have.type == "cpu":
        return True

    def index(d: torch.device) -> int:
        return torch.cuda.current_device() if d.index is None else d.index

    return index(have) == index(want)
