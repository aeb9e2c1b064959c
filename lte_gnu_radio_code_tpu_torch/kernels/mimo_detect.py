"""The 2x2 LMMSE detection of spatial multiplexing, as a pair of kernels.

No Pallas kernel stands behind it: the JAX package leaves the detection of
``lte_gnu_radio_code_tpu/models/mimo.py:rx_frame_mimo`` to XLA.  Per frame
and data bin, W = (H^H H + I / snr)^-1 H^H; x = W y on every data symbol;
then each layer of each frame scaled to unit mean power.  On a CUDA tensor
:func:`detect` launches ``csrc/mimo_detect.cu`` (a pass that sums each
layer's power, then one that writes the scaled phasors); on a CPU tensor it
runs the plain twin :func:`detect_plain`, the batched matmul form that
``models/mimo.py`` ran before.
"""

from __future__ import annotations

import math

import torch

from . import _cuda

launches = 0          # kernel launches since the last reset
SYMBOLS = 4           # data symbols a block (csrc/mimo_detect.cu: kSym)
BLOCK = 128           # bins a block, one a thread (kBlock)


def inv2x2(h: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of [..., 2, 2] complex matrices."""
    a, b = h[..., 0, 0], h[..., 0, 1]
    c, d = h[..., 1, 0], h[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    row0 = torch.stack([d, -b], -1)
    row1 = torch.stack([-c, a], -1)
    return torch.stack([row0, row1], -2) * inv_det[..., None, None]


def unit_power(ph: torch.Tensor) -> torch.Tensor:
    """Scaled to unit mean power over the last two axes."""
    p = (ph.abs() ** 2).mean((-2, -1), keepdim=True)
    return ph * torch.rsqrt(p.clamp_min(1e-30))


def detect_plain(fd: torch.Tensor, chan: torch.Tensor, bins: torch.Tensor,
                 inv_snr: float) -> torch.Tensor:
    """Plain twin of the kernels: :func:`detect` in batched matmuls."""
    _cuda.require_fp32(fd.device)
    hd = chan[..., bins].movedim(-1, -3)            # [..., B, rx, tx]
    hh = hd.conj().transpose(-1, -2)
    eye = torch.eye(2, dtype=hd.dtype, device=hd.device)
    w = inv2x2(hh @ hd + inv_snr * eye) @ hh
    yv = fd.movedim(-3, -1)[..., None]              # [..., KN, B, 2, 1]
    xhat = (w[..., None, :, :, :] @ yv)[..., 0]     # [..., KN, B, 2]
    return unit_power(xhat.movedim(-1, -3)).contiguous()


def detect(fd: torch.Tensor, chan: torch.Tensor, bins: torch.Tensor,
           inv_snr: float) -> torch.Tensor:
    """The derotated data bins fd [..., 2 rx, KN, B], the 2x2 channel chan
    [..., 2 rx, 2 tx, nfft] and the data bins' indices into it (int64 [B],
    each in [0, nfft)) -> both layers' phasors [..., 2, KN, B], each layer
    of each frame at unit mean power; all contiguous, complex64."""
    global launches
    if fd.ndim < 3:
        raise ValueError(f"fd: expected [..., 2, KN, B], got "
                         f"{tuple(fd.shape)}")
    *lead, _, kn, nb = fd.shape
    nfft = chan.shape[-1] if chan.ndim else 0
    _cuda.check(fd, "fd", torch.complex64, (*lead, 2, kn, nb))
    _cuda.check(chan, "chan", torch.complex64, (*lead, 2, 2, nfft))
    _cuda.check(bins, "bins", torch.int64, (nb,))
    if _cuda.on_cpu(fd, chan, bins):
        return detect_plain(fd, chan, bins, inv_snr)
    ph = torch.empty_like(fd)
    frames = math.prod(lead)
    if not (frames and kn and nb):
        return ph
    parts = -(-kn // SYMBOLS) * -(-nb // BLOCK)     # blocks a frame
    partial = torch.empty(frames, 2, parts, dtype=torch.float32,
                          device=fd.device)
    args = (fd.data_ptr(), chan.data_ptr(), bins.data_ptr(), frames, kn, nb,
            nfft, parts, inv_snr, partial.data_ptr())
    _cuda.launch("mimo_detect_power", fd.device, *args)
    _cuda.launch("mimo_detect_scale", fd.device, *args, ph.data_ptr())
    launches += 2
    return ph
