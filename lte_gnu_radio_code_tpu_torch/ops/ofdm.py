"""OFDM modulation ops in torch: resource-grid assembly and the symbol
FFT.

Port of ``lte_gnu_radio_code_tpu/ops/ofdm.py`` (``resource_grid`` in its
concat form, with or without scattered pilots, and ``symbol_fft``); the
IDFT, cyclic prefix and normalisation are K1's
(``kernels/ofdm_mod.py``).  Every function takes leading batch
dimensions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

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


def symbol_fft(cfg: OFDMConfig, windows: torch.Tensor) -> torch.Tensor:
    """FFT of CP-stripped symbol windows [..., nfft]
    (``ofdm.py:symbol_fft``)."""
    return torch.fft.fft(windows, cfg.nfft, dim=-1)
