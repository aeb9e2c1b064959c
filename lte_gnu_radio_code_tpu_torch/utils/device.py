"""Where the port's entry points run: on the CUDA device unless the caller
asks for the CPU.  The device is the one thing that picks kernel or twin:
each wrapper in ``kernels/`` launches its hand-written kernel on a CUDA
tensor and runs its plain PyTorch twin on a CPU tensor."""

from __future__ import annotations

import numpy as np
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


def as_samples(x, device: torch.device) -> torch.Tensor:
    """Samples (a tensor or anything numpy takes) as complex64 on device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.complex64))
    return x.to(device=device, dtype=torch.complex64)
