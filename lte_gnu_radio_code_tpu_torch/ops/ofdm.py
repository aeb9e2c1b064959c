"""OFDM modulation ops in torch: resource-grid assembly, IFFT + cyclic
prefix + the reference's two-stage per-symbol power normalisation.

Port of ``lte_gnu_radio_code_tpu/ops/ofdm.py`` (``resource_grid`` in its
concat form, with or without scattered pilots, ``cp_and_normalise``,
``modulate``, ``idft_fourstep``, ``modulate_fourstep``, ``symbol_fft``).
Every function takes leading batch dimensions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import _cuda
from ..utils.params import OFDMConfig, pilot_bin_plan, used_bins
from ..utils.tables import device_table
from .pilots import pilot_values
from .zadoff_chu import zc_for_config


@functools.lru_cache(maxsize=16)
def _zc_rows(cfg: OFDMConfig) -> np.ndarray:
    """[n_synch_symbols, num_synch_bins] ZC slice of each synch symbol."""
    n_synch = cfg.num_patterns * cfg.m_synch
    slice_idx = np.arange(n_synch) % cfg.m_synch
    return zc_for_config(cfg).reshape(cfg.m_synch, -1)[slice_idx]


@functools.lru_cache(maxsize=16)
def _row_order(cfg: OFDMConfig) -> np.ndarray:
    """Grid row -> row of the stacked [synch rows; data rows]."""
    pattern = np.asarray(cfg.symbol_pattern())
    synch_rows = np.where(pattern == 0)[0]
    data_rows = np.where(pattern == 1)[0]
    order = np.empty(cfg.num_ofdm_symb, np.int64)
    order[synch_rows] = np.arange(len(synch_rows))
    order[data_rows] = len(synch_rows) + np.arange(len(data_rows))
    return order


def _rows_from_vals(vals: torch.Tensor, nfft: int) -> torch.Tensor:
    """[..., nb] used-bin values -> [..., nfft] rows: used_bins puts the
    first half on the negative (tail) bins and the second half on 1..h, so
    a row is [0 | second half | zero gap | first half]."""
    h = vals.shape[-1] // 2
    lead = vals.shape[:-1]
    return torch.cat([vals.new_zeros(*lead, 1), vals[..., h:],
                      vals.new_zeros(*lead, nfft - 2 * h - 1),
                      vals[..., :h]], -1)


@functools.lru_cache(maxsize=16)
def _pilot_merge_order(cfg: OFDMConfig) -> np.ndarray:
    """Used-bin position -> column of [data-only values | pilot values]:
    the order that interleaves the two back onto the used bins."""
    _, all_wrapped = used_bins(cfg.nfft, cfg.num_data_bins)
    _, p_wrapped, _, d_wrapped = pilot_bin_plan(cfg)
    col = {b: i for i, b in enumerate(d_wrapped + p_wrapped)}
    return np.asarray([col[b] for b in all_wrapped], np.int64)


def resource_grid(cfg: OFDMConfig, data_symbols: torch.Tensor
                  ) -> torch.Tensor:
    """[..., num_data_symb, num_data_only_bins] data -> [...,
    num_ofdm_symb, nfft] grid with the ZC synch symbols
    (``ofdm.py:resource_grid``).  With a pilot grid the known pilot values
    sit on the pilot bins of every data symbol and the data on the rest;
    the values are merged into used-bin order by one static gather, the
    JAX package's scatters written as the concat form."""
    lead = data_symbols.shape[:-2]
    dev = data_symbols.device
    zc = device_table(_zc_rows, dev, cfg)
    srows = _rows_from_vals(zc.expand(*lead, *zc.shape), cfg.nfft)
    vals = data_symbols.to(torch.complex64)
    if cfg.pilot_grid != "none":
        pv = device_table(pilot_values, dev, cfg)
        vals = torch.cat([vals, pv.expand(*vals.shape[:-1], -1)], -1)[
            ..., device_table(_pilot_merge_order, dev, cfg)]
    drows = _rows_from_vals(vals, cfg.nfft)
    order = device_table(_row_order, dev, cfg)
    return torch.cat([srows, drows], -2).index_select(-2, order)


def cp_and_normalise(cfg: OFDMConfig, x: torch.Tensor) -> torch.Tensor:
    """[..., S, nfft] time symbols -> [..., S*(nfft+cp)] frame: CP prepend,
    scale each symbol to unit mean energy, then divide by sqrt of its
    mean-subtracted complex variance (``ofdm.py:cp_and_normalise``)."""
    t = torch.cat([x[..., -cfg.cp_len:], x], -1)
    n = t.shape[-1]
    energy = (t.abs() ** 2).sum(-1, keepdim=True)
    t = t * torch.where(energy > 1e-30, torch.sqrt(n / energy), 1.0)
    mean = t.mean(-1, keepdim=True)
    p = ((t - mean).abs() ** 2).mean(-1, keepdim=True)
    t = t / torch.sqrt(p)
    return t.reshape(*t.shape[:-2], -1).to(torch.complex64)


def modulate(cfg: OFDMConfig, grid: torch.Tensor) -> torch.Tensor:
    """[..., S, nfft] grid -> [..., S*(nfft+cp)] frame via torch.fft
    (``ofdm.py:modulate``)."""
    return cp_and_normalise(cfg, torch.fft.ifft(grid, cfg.nfft, dim=-1))


@functools.lru_cache(maxsize=16)
def _fourstep_mats(nfft: int) -> tuple:
    """Cooley-Tukey N = N1*N2 factor matrices of the IDFT as two matrix
    products (``ofdm._fourstep_mats``).  With k = k1*N2 + k2 and
    n = n1 + N1*n2:
      x[n1 + N1 n2] = (1/N) sum_k2 W2[n2,k2] T[n1,k2] sum_k1 X[k1,k2] W1[n1,k1]
    W1[n1,k1] = e^{+2 pi i n1 k1/N1}, W2[n2,k2] = e^{+2 pi i n2 k2/N2} and
    the twiddles T[n1,k2] = e^{+2 pi i n1 k2/N} (here with the 1/N)."""
    n1 = 1 << (int(np.log2(nfft)) + 1) // 2     # ~sqrt split, n1 >= n2
    n2 = nfft // n1
    w1 = np.exp(2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    w2 = np.exp(2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    tw = np.exp(2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / nfft)
    return (n1, n2, w1.astype(np.complex64), w2.astype(np.complex64),
            (tw / nfft).astype(np.complex64))


def _fourstep_table(nfft: int, k: int) -> np.ndarray:
    return _fourstep_mats(nfft)[k]


def idft_fourstep(nfft: int, grid: torch.Tensor) -> torch.Tensor:
    """[..., nfft] IDFT as two matrix-product rounds and the twiddles
    (``ofdm.idft_fourstep``); torch.fft.ifft to float32 rounding."""
    n1, n2 = _fourstep_mats(nfft)[:2]
    dev = grid.device
    _cuda.require_fp32(dev)
    w1, w2, tw = (device_table(_fourstep_table, dev, nfft, k)
                  for k in (2, 3, 4))
    lead = grid.shape[:-1]
    xm = grid.to(torch.complex64).reshape(*lead, n1, n2)     # [., k1, k2]
    a = torch.einsum("...kj,nk->...nj", xm, w1) * tw         # [., n1, k2]
    b = torch.einsum("...nj,mj->...nm", a, w2)               # [., n1, n2]
    # n = n1 + N1*n2: the output in [n2, n1] order
    return b.transpose(-1, -2).reshape(*lead, nfft)


def modulate_fourstep(cfg: OFDMConfig, grid: torch.Tensor) -> torch.Tensor:
    """:func:`modulate` with the IDFT as :func:`idft_fourstep`
    (``ofdm.modulate_fourstep``)."""
    return cp_and_normalise(cfg, idft_fourstep(cfg.nfft, grid))


def symbol_fft(cfg: OFDMConfig, windows: torch.Tensor) -> torch.Tensor:
    """FFT of CP-stripped symbol windows [..., nfft]
    (``ofdm.py:symbol_fft``)."""
    return torch.fft.fft(windows, cfg.nfft, dim=-1)
