"""OFDM modulation ops in torch: resource-grid assembly, IFFT + cyclic
prefix + the reference's two-stage per-symbol power normalisation.

Port of ``lte_gnu_radio_code_tpu/ops/ofdm.py`` (``resource_grid`` in its
pilot-free concat form, ``cp_and_normalise``, ``modulate``).  Every function
takes leading batch dimensions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.params import OFDMConfig
from ..utils.tables import device_table
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


def resource_grid(cfg: OFDMConfig, data_symbols: torch.Tensor
                  ) -> torch.Tensor:
    """[..., num_data_symb, num_data_bins] data -> [..., num_ofdm_symb,
    nfft] grid with the ZC synch symbols (``ofdm.py:resource_grid``)."""
    if cfg.pilot_grid != "none":
        raise NotImplementedError("pilot grids are not ported yet")
    lead = data_symbols.shape[:-2]
    dev = data_symbols.device
    zc = device_table(_zc_rows, dev, cfg)
    srows = _rows_from_vals(zc.expand(*lead, *zc.shape), cfg.nfft)
    drows = _rows_from_vals(data_symbols.to(torch.complex64), cfg.nfft)
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
