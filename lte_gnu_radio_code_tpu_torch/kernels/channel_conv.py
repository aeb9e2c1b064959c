"""K3: short-CIR multipath channel convolution of a frame batch.

Port of ``lte_gnu_radio_code_tpu/pallas_kernels/channel_conv.py``
(``conv_frames``, ``apply_channel_frames``).  On a CUDA tensor the wrapper
launches ``csrc/channel_conv.cu``; on a CPU tensor it runs the plain twin,
the ascending-tap shifted-add form of ``ops/channel.py``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import channel as chan_ops
from . import _cuda

launches = 0          # kernel launches since the last reset
MAX_TAPS = 16


def apply_channel_frames_plain(x: torch.Tensor, h: np.ndarray,
                               max_impulse: int) -> torch.Tensor:
    """Plain twin of K3: [B, n] -> [B, n + max_impulse - 1]."""
    y = chan_ops.shifted_add(x, h)
    return F.pad(y, (0, x.shape[1] + max_impulse - 1 - y.shape[1]))


def apply_channel_frames(x: torch.Tensor, h: np.ndarray,
                         max_impulse: int) -> torch.Tensor:
    """[B, n] complex frames (*) h (<= 16 complex taps, numpy) ->
    [B, n + max_impulse - 1], zero past the CIR's n + taps - 1 samples."""
    global launches
    h = np.asarray(h, np.complex64)
    if h.ndim != 1 or not 1 <= h.shape[0] <= MAX_TAPS:
        raise ValueError(f"channel_conv takes 1..{MAX_TAPS} taps, got "
                         f"shape {h.shape}")
    if max_impulse < h.shape[0]:
        raise ValueError("max_impulse is shorter than the CIR")
    if _cuda.on_cpu(x):
        return apply_channel_frames_plain(x, h, max_impulse)
    b, n = x.shape
    _cuda.check(x, "x", torch.complex64, (b, n))
    n_out = n + max_impulse - 1
    y = torch.empty(b, n_out, dtype=torch.complex64, device=x.device)
    taps = (ctypes.c_float * (2 * h.shape[0]))(
        *np.stack([h.real, h.imag], 1).ravel().tolist())
    if b:
        _cuda.launch("channel_conv", x.device, x.data_ptr(), y.data_ptr(),
                     b, n, n_out, ctypes.addressof(taps), h.shape[0])
        launches += 1
    return y


def conv_frames(x: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """[B, n] (*) h -> [B, n + taps - 1] (the full convolution only)."""
    return apply_channel_frames(x, h, np.asarray(h).shape[0])
