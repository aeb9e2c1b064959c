"""The FFT kernels of K1 (``ofdm_mod``), K2 (``equalize``) and K4's FFT
route (``sync_search``): which lengths they take, the radix plan they run,
and the twiddle table they read.

The rule is on the shape alone: on a CUDA tensor the wrappers launch the
shared-memory FFT kernels (``csrc/fft.cuh``) for an nfft that is a power of
two in [16, 4096], which every shipped config is, and raise ``ValueError``
for any other.  The plain twins on a CPU tensor take any nfft.
"""

from __future__ import annotations

import functools

import numpy as np

MIN_NFFT, MAX_NFFT = 16, 4096


def takes_fft(nfft: int) -> bool:
    """True when nfft is a power of two in [16, 4096]."""
    return MIN_NFFT <= nfft <= MAX_NFFT and nfft & (nfft - 1) == 0


def require(nfft: int) -> None:
    """Raises ValueError unless the FFT kernels take nfft."""
    if not takes_fft(nfft):
        raise ValueError(f"nfft {nfft}: the CUDA kernels take a power of two "
                         f"in [{MIN_NFFT}, {MAX_NFFT}]")


def plan(nfft: int) -> tuple[int, ...]:
    """The radices of the Stockham stages the kernels run, in order:
    radix 4, then one radix-2 stage where log2(nfft) is odd."""
    require(nfft)
    log2 = nfft.bit_length() - 1
    return (4,) * (log2 // 2) + (2,) * (log2 % 2)


@functools.lru_cache(maxsize=16)
def twiddles(nfft: int) -> np.ndarray:
    """[nfft] e^{-2 pi i m / nfft}, built in float64, stored as complex64;
    a stage of radix R after sub-transforms of length P reads w^(j k) at
    entry j k nfft / (P R)."""
    return np.exp(-2j * np.pi * np.arange(nfft) / nfft).astype(np.complex64)
