"""Device choice for the port.

``resolve_device(None)`` is CUDA and raises where CUDA is unavailable: the
port never drops to the CPU behind the caller's back.  The CPU is taken
only when the caller names it, as the tests do.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> torch.device("cuda"), raising when CUDA is unavailable; an
    explicit "cpu" / "cuda[:i]" / torch.device is taken as given (a CUDA
    device still raises without CUDA)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pinot_tpu_torch runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
