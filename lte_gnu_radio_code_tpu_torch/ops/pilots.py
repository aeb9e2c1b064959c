"""Scattered-pilot ops in torch: the known pilot values, the least-squares
channel estimate at the pilot bins, its interpolation to the data-only bins,
and the pilot-equalised data demod.

Port of ``lte_gnu_radio_code_tpu/ops/pilots.py`` (``pilot_values``,
``_cir_interp_matrix``, ``_cir_condition``, ``estimate_channel_from_pilots``,
``equalize_data_symbols_pilot``).  The constant tables are built in numpy
exactly as there (float64 ``pinv``, ``RandomState`` draws) and moved to the
device once.  Every function takes leading frame dimensions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import _cuda, equalize
from ..utils.params import OFDMConfig, pilot_bin_plan, used_bins
from ..utils.tables import device_table
from .modulation import QPSK_POINTS
from .sync import mmse_gain


@functools.lru_cache(maxsize=None)
def pilot_values(cfg: OFDMConfig) -> np.ndarray:
    """Known unit-modulus QPSK pilot values, one per pilot bin, drawn from a
    generator seeded with ``pilot_seed + 1`` (``pilots.py:pilot_values``)."""
    rng = np.random.RandomState(cfg.pilot_seed + 1)
    return QPSK_POINTS[rng.randint(0, 4, size=cfg.num_pilot_bins)
                       ].astype(np.complex64)


def _pilot_dft(cfg: OFDMConfig):
    """DFT submatrices at the pilot and data-only bins over the CIR taps
    [-n/4, 3n/4), n = min(cp_len, pilots): one tap per pilot observation at
    most, with an anti-causal guard for the sync's residual timing error."""
    p_signed, _, d_signed, _ = pilot_bin_plan(cfg)
    n_taps = min(cfg.cp_len, len(p_signed))
    guard = n_taps // 4
    n = np.arange(-guard, n_taps - guard)
    a = np.exp(-2j * np.pi * np.asarray(p_signed)[:, None] * n[None, :]
               / cfg.nfft)
    b = np.exp(-2j * np.pi * np.asarray(d_signed)[:, None] * n[None, :]
               / cfg.nfft)
    return a, b


@functools.lru_cache(maxsize=None)
def _cir_interp_matrix(cfg: OFDMConfig) -> np.ndarray:
    """[num_data_only_bins, num_pilot_bins] transform-domain interpolator
    B @ pinv(A): H on the pilot bins gives the CIR by least squares, and the
    CIR gives H on the data bins (``pilots.py:_cir_interp_matrix``)."""
    a, b = _pilot_dft(cfg)
    return (b @ np.linalg.pinv(a)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _cir_condition(cfg: OFDMConfig) -> float:
    """Condition number of the pilot-bin DFT submatrix."""
    return float(np.linalg.cond(_pilot_dft(cfg)[0]))


@functools.lru_cache(maxsize=None)
def _linear_interp_plan(cfg: OFDMConfig) -> tuple[np.ndarray, np.ndarray]:
    """(left [D] int64, weight [D] float32) of the piecewise-linear
    interpolation from the pilot bins to the data-only bins along the
    signed-bin axis: H_d = H_p[left] + weight * (H_p[left + 1] - H_p[left]),
    what ``jnp.interp`` computes there.  Both bin lists are static, so the
    search runs once in numpy; a data bin outside the pilots' span takes
    the nearest pilot's value (weight 0 or 1)."""
    p_signed, _, d_signed, _ = pilot_bin_plan(cfg)
    xp = np.asarray(p_signed, np.float32)
    xq = np.asarray(d_signed, np.float32)
    right = np.clip(np.searchsorted(xp, xq, side="right"), 1, len(xp) - 1)
    left = right - 1
    w = (xq - xp[left]) / (xp[right] - xp[left])
    return left.astype(np.int64), np.clip(w, 0.0, 1.0).astype(np.float32)


def _linear_left(cfg: OFDMConfig) -> np.ndarray:
    return _linear_interp_plan(cfg)[0]


def _linear_weight(cfg: OFDMConfig) -> np.ndarray:
    return _linear_interp_plan(cfg)[1]


def interp_route(cfg: OFDMConfig, interp: str = "auto") -> str:
    """"cir" or "linear": ``interp`` itself, or for "auto" the transform-
    domain form unless the pilot layout is too ill-conditioned for it
    (condition above 1e4, as at LTE1024 with spacing 6)."""
    if interp != "auto":
        return interp
    n_pilots = len(pilot_bin_plan(cfg)[0])
    return "cir" if n_pilots >= 2 and _cir_condition(cfg) < 1e4 else "linear"


def estimate_channel_from_pilots(cfg: OFDMConfig, fd_pilots: torch.Tensor,
                                 interp: str = "auto") -> torch.Tensor:
    """LS estimate at the pilot bins -> H at the data-only bins
    (``pilots.py:estimate_channel_from_pilots``).

    fd_pilots [..., num_data_symb, num_pilot_bins]: received pilot-bin
    values, power-normalised and timing-derotated.  H_p = Y_p conj(X_p) /
    (|X_p|^2 + 1/SNR), averaged over the symbol axis, then interpolated:
    "cir" one product with :func:`_cir_interp_matrix`, "linear" piecewise
    linear across the signed-bin axis, "auto" by :func:`interp_route`.
    Returns [..., num_data_only_bins] complex64."""
    dev = fd_pilots.device
    pv = device_table(pilot_values, dev, cfg)
    h_p = fd_pilots * pv.conj() / (pv.abs() ** 2 + 1.0 / cfg.snr_linear)
    h_p = h_p.mean(-2)
    if interp_route(cfg, interp) == "cir":
        _cuda.require_fp32(dev)
        return h_p @ device_table(_cir_interp_matrix, dev, cfg).T
    left = device_table(_linear_left, dev, cfg)
    lo = h_p[..., left]
    return lo + device_table(_linear_weight, dev, cfg) * (
        h_p[..., left + 1] - lo)


@functools.lru_cache(maxsize=None)
def _used_columns(cfg: OFDMConfig, pilots: bool) -> np.ndarray:
    """Columns of the used-bin axis that hold the pilots (in pilot order),
    or the data (in data-only order)."""
    _, all_wrapped = used_bins(cfg.nfft, cfg.num_data_bins)
    pos = {b: i for i, b in enumerate(all_wrapped)}
    wrapped = pilot_bin_plan(cfg)[1 if pilots else 3]
    return np.asarray([pos[b] for b in wrapped], np.int64)


def equalize_data_symbols_pilot(cfg: OFDMConfig, x: torch.Tensor, lock_ptr,
                                delay_idx, num_patterns: int,
                                return_chan: bool = False):
    """Pilot-based stage B (``pilots.py:equalize_data_symbols_pilot``): the
    spectrum of every data window on the used bins, power-normalised and
    derotated by the lock's delay, split into pilot and data-only columns;
    the channel from the pilots; MMSE equalisation of the data columns.

    x [..., n], lock_ptr and delay_idx [...] -> phasors [...,
    num_patterns*nd, num_data_only_bins] (and H at the data-only bins
    [..., num_data_only_bins] with ``return_chan``).

    The used bins are K2's bins, so the first step is K2 with the
    coefficient set to the rotation alone: one call of
    ``kernels.equalize.demod_windows`` over every window of every frame,
    on a CUDA tensor one K2 launch, on a CPU tensor its plain twin.  K2
    clamps a window's power at 1e-30 where the JAX function's FFT does
    not; they differ only on an all-zero window."""
    if len(pilot_bin_plan(cfg)[0]) < 2:
        raise ValueError("pilot equalisation needs at least 2 pilot bins")
    dev = x.device
    win = equalize.data_windows(cfg, x, lock_ptr, num_patterns)
    rot = equalize.derotation(cfg, delay_idx, dev)            # [..., B]
    fu = equalize.demod_frames(cfg, win, rot)
    fp = fu[..., device_table(_used_columns, dev, cfg, True)]
    fd = fu[..., device_table(_used_columns, dev, cfg, False)]
    h_d = estimate_channel_from_pilots(cfg, fp)
    out = fd * mmse_gain(h_d, cfg.snr_linear)[..., None, :]
    return (out, h_d) if return_chan else out
