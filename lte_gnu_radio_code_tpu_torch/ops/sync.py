"""Synchronisation, channel estimation and MMSE equalisation in torch (the
loopback chain's subset).

Port of ``lte_gnu_radio_code_tpu/ops/sync.py``: ``n_trials_for``,
``sync_spectra``, ``sync_spectrum_at``, ``sync_correlate``,
``sync_correlate_ifft``, ``corr_abs_from_spectra``, ``first_lock``,
``estimate_channel``, ``mmse_gain`` and ``equalize_data_symbols`` (the plain
twin of K2's caller).  Functions that take a lock take leading frame
dimensions: x [..., n] with one lock per frame.  The refractory
(multi-detection) selection waits with the streaming receivers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import _cuda
from ..utils.params import OFDMConfig, used_bins
from ..utils.tables import device_table
from .zadoff_chu import delay_search_matrix, zc_for_config


def n_trials_for(cfg: OFDMConfig, n_samples: int) -> int:
    """Stride-spaced sync trials that fit in an n_samples buffer."""
    need = cfg.m_synch * cfg.rx_b_len + cfg.nfft + cfg.cp_len
    return max(0, (n_samples - need - 1) // cfg.stride + 1)


def _bins(nfft: int, num_bins: int) -> np.ndarray:
    return np.asarray(used_bins(nfft, num_bins)[1], np.int64)


def _bins_on(device, nfft: int, num_bins: int) -> torch.Tensor:
    """Wrapped FFT indices of the used bins, as a tensor on device."""
    return device_table(_bins, device, nfft, num_bins)


def windows_at(x: torch.Tensor, start, rel: torch.Tensor) -> torch.Tensor:
    """x[..., start + rel] for x [..., n], one start per frame [...] and an
    int64 offset table rel [*s] on x's device: result [..., *s].  As the JAX
    package's edge-padded dynamic slice: start clamps to [0, n] and indices
    past the end read the last sample."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    st = torch.as_tensor(start, device=x.device).to(torch.int64)
    st = st.clamp(0, n).expand(lead).reshape(*lead, *([1] * rel.ndim))
    idx = (st + rel).clamp_max(n - 1)
    return torch.gather(x, -1, idx.reshape(*lead, -1)).reshape(
        *lead, *rel.shape)


def sync_spectra(cfg: OFDMConfig, x: torch.Tensor,
                 n_trials: int) -> torch.Tensor:
    """Power-normalised synch-bin spectra of every trial: x [n] ->
    [n_trials, m_synch*num_synch_bins] (``sync.py:sync_spectra``)."""
    starts = cfg.cp_len + cfg.stride * np.arange(n_trials)
    offs = (np.arange(cfg.m_synch) * cfg.rx_b_len)[:, None] + \
        np.arange(cfg.nfft)[None, :]
    idx = torch.as_tensor(starts[:, None, None] + offs[None], device=x.device)
    f = torch.fft.fft(x[idx], cfg.nfft, dim=-1)
    s = f[..., _bins_on(x.device, cfg.nfft, cfg.num_synch_bins)].reshape(
        n_trials, -1)
    power = (s.abs() ** 2).sum(-1, keepdim=True)
    return s * torch.sqrt(s.shape[-1] / power)


@functools.lru_cache(maxsize=32)
def _dft_synch_bins(nfft: int, num_bins: int) -> np.ndarray:
    """[nfft, L] DFT basis on the synch bins (``sync._dft_synch_bins``)."""
    n = np.arange(nfft)
    return np.exp(-2j * np.pi * np.outer(n, _bins(nfft, num_bins)) / nfft
                  ).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _synch_window_offsets(cfg: OFDMConfig) -> np.ndarray:
    """[m_synch, nfft] offsets of a trial's CP-skipped synch windows."""
    return ((np.arange(cfg.m_synch) * cfg.rx_b_len)[:, None] +
            np.arange(cfg.nfft)[None, :])


def sync_spectrum_at(cfg: OFDMConfig, x: torch.Tensor, trial,
                     method: str | None = None) -> torch.Tensor:
    """Power-normalised synch-bin spectrum at one trial per frame: x
    [..., n], trial [...] -> [..., m_synch*num_synch_bins]
    (``sync.py:sync_spectrum_at``; method "dft" is a matmul against the
    synch-bin DFT basis, None a torch.fft)."""
    win = windows_at(x, cfg.cp_len + cfg.stride *
                     torch.as_tensor(trial, device=x.device),
                     device_table(_synch_window_offsets, x.device, cfg))
    if method == "dft":
        _cuda.require_fp32(x.device)
        basis = device_table(_dft_synch_bins, x.device, cfg.nfft,
                             cfg.num_synch_bins)
        s = win @ basis
    else:
        s = torch.fft.fft(win, cfg.nfft, dim=-1)[
            ..., _bins_on(x.device, cfg.nfft, cfg.num_synch_bins)]
    s = s.reshape(*s.shape[:-2], -1)
    power = (s.abs() ** 2).sum(-1, keepdim=True)
    return s * torch.sqrt(s.shape[-1] / power.clamp_min(1e-30))


def sync_correlate(cfg: OFDMConfig, spectra: torch.Tensor) -> torch.Tensor:
    """corr[p, d] = sum_k e^{+j2pi d b_k/N} S[p,k] conj(ZC[k]) as one matmul
    (``sync.py:sync_correlate``)."""
    _cuda.require_fp32(spectra.device)
    zc = device_table(zc_for_config, spectra.device, cfg)
    dse = device_table(delay_search_matrix, spectra.device, cfg)
    return (spectra * zc.conj()) @ dse.T


def sync_correlate_ifft(cfg: OFDMConfig,
                        spectra: torch.Tensor) -> torch.Tensor:
    """The same correlation as one inverse FFT per trial
    (``sync.py:sync_correlate_ifft``)."""
    zc = device_table(zc_for_config, spectra.device, cfg)
    p = spectra.shape[0]
    q = (spectra * zc.conj()).reshape(p, cfg.m_synch,
                                      cfg.num_synch_bins).sum(1)
    y = spectra.new_zeros(p, cfg.nfft)
    y[:, _bins_on(y.device, cfg.nfft, cfg.num_synch_bins)] = q
    return cfg.nfft * torch.fft.ifft(y, dim=-1)[:, : cfg.cp_len + 1]


def corr_abs_from_spectra(cfg: OFDMConfig, spectra: torch.Tensor,
                          method: str) -> torch.Tensor:
    """|corr| [p, cp+1] from trial spectra: "ifft" or the dense "exact"
    (``sync.py:corr_abs_from_spectra``)."""
    if method == "ifft":
        return sync_correlate_ifft(cfg, spectra).abs()
    if method == "exact":
        return sync_correlate(cfg, spectra).abs()
    raise ValueError(f"corr_abs_from_spectra: unknown method {method!r}; "
                     "expected 'ifft' or 'exact'")


def first_lock(cfg: OFDMConfig, corr_abs: torch.Tensor):
    """First trial whose peak crosses the gate, per frame: corr_abs
    [..., p, D] -> (ptr, delay_idx, peak, found, first), each [...]
    (``sync.py:first_lock``).  Ties go to the first index, as jnp.argmax."""
    dmax_val = corr_abs.amax(-1)
    dmax_ind = corr_abs.argmax(-1)
    # the Python-float gate is rounded to float32 for the comparison, as
    # JAX rounds its weakly typed scalar
    mask = dmax_val > cfg.detection_gate * cfg.m_synch * cfg.num_synch_bins
    found = mask.any(-1)
    first = mask.to(torch.int32).argmax(-1)       # argmax rejects bool
    ptr = cfg.cp_len + cfg.stride * first
    delay = dmax_ind.gather(-1, first[..., None])[..., 0]
    peak = dmax_val.gather(-1, first[..., None])[..., 0]
    return ptr, delay, peak, found, first


def estimate_channel(cfg: OFDMConfig, spectrum: torch.Tensor, delay_idx):
    """ZC-correlation channel estimate from the lock spectrum, per frame:
    spectrum [..., m_synch*L], delay_idx [...] -> (chan_est [..., L],
    chan_full [..., nfft], cir [..., nfft]) (``sync.py:estimate_channel``)."""
    dev = spectrum.device
    zc = device_table(zc_for_config, dev, cfg)
    dse = device_table(delay_search_matrix, dev, cfg)
    data_recov = dse[torch.as_tensor(delay_idx, device=dev)] * spectrum
    tmp = (data_recov * zc.conj()) / (1.0 / cfg.snr_linear + 1.0)
    lead = spectrum.shape[:-1]
    chan_est = tmp.reshape(*lead, cfg.m_synch, cfg.num_synch_bins).mean(-2)
    full = spectrum.new_zeros(*lead, cfg.nfft)
    full[..., _bins_on(dev, cfg.nfft, cfg.num_synch_bins)] = chan_est
    return chan_est, full, torch.fft.ifft(full, cfg.nfft, dim=-1)


def mmse_gain(chan: torch.Tensor, snr_lin: float) -> torch.Tensor:
    """One-tap MMSE gain conj(H) / (|H|^2 + 1/SNR)."""
    return chan.conj() / (1.0 / snr_lin + chan.abs() ** 2)


@functools.lru_cache(maxsize=16)
def data_window_offsets(cfg: OFDMConfig, num_patterns: int) -> np.ndarray:
    """[num_patterns*nd, nfft] offsets of the data-symbol windows from the
    lock pointer."""
    m0, nd = cfg.m_synch, cfg.synch_dat[1]
    block = cfg.pattern_len * cfg.rx_b_len
    return (np.arange(num_patterns)[:, None, None] * block +
            (m0 + np.arange(nd))[None, :, None] * cfg.rx_b_len +
            np.arange(cfg.nfft)[None, None, :]).reshape(-1, cfg.nfft)


def equalize_data_symbols(cfg: OFDMConfig, x: torch.Tensor, lock_ptr,
                          delay_idx, chan_full: torch.Tensor,
                          num_patterns: int) -> torch.Tensor:
    """FFT + power norm + timing derotation + MMSE EQ of every data symbol
    at each frame's lock: x [..., n] -> [..., num_patterns*nd,
    num_data_bins] (``sync.py:equalize_data_symbols``)."""
    data_bins = _bins_on(x.device, cfg.nfft, cfg.num_data_bins)
    win = windows_at(x, lock_ptr, device_table(data_window_offsets, x.device,
                                               cfg, num_patterns))
    fd = torch.fft.fft(win, cfg.nfft, dim=-1)[..., data_bins]
    power = (fd.abs() ** 2).sum(-1, keepdim=True)
    fd = fd * torch.sqrt(fd.shape[-1] / power)
    delay = torch.as_tensor(delay_idx, device=x.device).to(torch.float32)
    rot = torch.exp((1j * 2.0 * np.pi / cfg.nfft) * delay[..., None] *
                    data_bins.to(torch.float32))
    eq = mmse_gain(chan_full[..., data_bins], cfg.snr_linear)
    return fd * rot[..., None, :] * eq[..., None, :]
