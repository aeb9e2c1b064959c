"""Where the port's entry points run: on the CUDA device unless the caller
asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(name=None) -> torch.device:
    """The torch device ``name`` (None: "cuda").  Raises where it is a CUDA
    device and none is present: nothing moves to the CPU unless the caller
    asks for it."""
    device = torch.device("cuda" if name is None else name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device is "
                           "present; ask for the device \"cpu\" to run the "
                           "kernels' plain twins on the CPU")
    return device
