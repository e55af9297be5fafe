"""Where the port's entry points run: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """None means CUDA. A CUDA device on a machine without one raises: the
    port never drops quietly to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device
