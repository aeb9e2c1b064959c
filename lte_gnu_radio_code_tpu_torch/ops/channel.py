"""Channel simulation ops in torch: multipath convolution and AWGN.

Port of ``lte_gnu_radio_code_tpu/ops/channel.py`` (``channel_taps``,
``apply_channel``, ``noise_variance``, ``awgn``); the MIMO channel waits.
Random numbers come from an explicit ``torch.Generator`` or from a noise
tensor the caller made, so tests can hand one numpy noise array to both
packages.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import _cuda
from ..utils.params import OFDMConfig

CHANNELS_SISO = {
    "Ideal": np.array([1.0 + 0j]),
    "IMT1": np.array([0.0, 1.0 + 0j]),
    "IMT16": np.array([0.0] * 15 + [1.0 + 0j]),
    "Fading": np.array([0.3977, 0.7954 - 0.3977j, -0.1988, 0.0994, -0.0398]),
    "AWGN": np.array([0.0, 1.0 + 0j]),
}


def channel_taps(name: str, dtype=np.complex64) -> np.ndarray:
    """Unit-norm SISO CIR (``channel.py:channel_taps``)."""
    h = CHANNELS_SISO[name]
    return (h / np.linalg.norm(h)).astype(dtype)


def shifted_add(sig: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """[..., n] (*) h -> [..., n + taps - 1] as ascending-tap shifted adds
    (``channel.py:apply_channel``, <= 16 taps); the plain twin of K3."""
    th = h.shape[-1]
    y = sig.new_zeros(*sig.shape[:-1], sig.shape[-1] + th - 1)
    for k in range(th):
        y = y + complex(np.complex64(h[k])) * F.pad(sig, (k, th - 1 - k))
    return y


def _direct_conv_full(sig: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """Full linear convolution as one real conv1d with 2 in / 2 out
    channels (``channel.py:_direct_conv_full``)."""
    th = h.shape[-1]
    lead, n = sig.shape[:-1], sig.shape[-1]
    x = torch.stack([sig.real, sig.imag], -2).reshape(-1, 2, n)
    hf = h[::-1]
    k = np.stack([np.stack([hf.real, -hf.imag]),
                  np.stack([hf.imag, hf.real])]).astype(np.float32)
    _cuda.require_fp32(sig.device)
    y = F.conv1d(x, torch.from_numpy(k).to(sig.device), padding=th - 1)
    return torch.complex(y[:, 0], y[:, 1]).reshape(*lead, -1)


def apply_channel(sig: torch.Tensor, h: np.ndarray,
                  max_impulse: int | None = None) -> torch.Tensor:
    """[..., n] (*) h -> [..., n + max(max_impulse, taps) - 1], the tail
    past the true taps zero (``channel.py:apply_channel``): shifted adds up
    to 16 taps, one conv1d up to 256, an FFT product above."""
    h = np.asarray(h)
    taps = h.shape[-1] if max_impulse is None else max(max_impulse,
                                                       h.shape[-1])
    n_out = sig.shape[-1] + taps - 1
    if h.shape[-1] <= 16:
        y = shifted_add(sig, h)
    elif h.shape[-1] <= 256:
        y = _direct_conv_full(sig, h)
    else:
        nfft = int(2 ** np.ceil(np.log2(max(n_out, 2))))
        hh = torch.from_numpy(h.astype(np.complex64)).to(sig.device)
        y = torch.fft.ifft(torch.fft.fft(sig, nfft) * torch.fft.fft(hh, nfft),
                           nfft)[..., :n_out]
    return F.pad(y, (0, n_out - y.shape[-1])).to(torch.complex64)


def noise_variance(cfg: OFDMConfig, sig_pow):
    """Digital/Analog SNR -> complex noise variance
    (``channel.py:noise_variance``)."""
    if cfg.snr_type == "Digital":
        bits_per_symb = cfg.num_data_bins * cfg.bits_per_bin
        return ((1.0 / bits_per_symb) * cfg.rx_b_len * sig_pow *
                10 ** (-cfg.snr_db / 10))
    return sig_pow * 10 ** (-cfg.snr_db / 10)


def awgn(cfg: OFDMConfig, rx: torch.Tensor, sig_pow, *,
         generator: torch.Generator | None = None,
         noise: torch.Tensor | None = None) -> torch.Tensor:
    """rx + sqrt(nv/2) * (n_re + j n_im), n_re, n_im ~ N(0, 1)
    (``channel.py:awgn``).  ``sig_pow`` broadcasts against ``rx`` ([B, 1]
    for per-frame powers).  Exactly one of ``generator`` (a generator on
    rx's device) and ``noise`` (complex, rx's shape) must be given."""
    if (generator is None) == (noise is None):
        raise ValueError("awgn: pass exactly one of generator= and noise=")
    if noise is None:
        nr = torch.randn(rx.shape, generator=generator, device=rx.device)
        ni = torch.randn(rx.shape, generator=generator, device=rx.device)
        noise = torch.complex(nr, ni)
    elif noise.shape != rx.shape or noise.device != rx.device:
        raise ValueError(f"awgn: noise {tuple(noise.shape)} on "
                         f"{noise.device}, rx {tuple(rx.shape)} on "
                         f"{rx.device}")
    nv = noise_variance(cfg, sig_pow)
    return rx + torch.sqrt(torch.as_tensor(nv / 2.0, dtype=torch.float32,
                                           device=rx.device)) * noise
