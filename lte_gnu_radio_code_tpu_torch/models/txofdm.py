"""TX model in torch: bits -> constellation -> resource grid -> IDFT + CP +
normalisation -> time frame.

Port of ``lte_gnu_radio_code_tpu/models/txofdm.py`` (``tx_frame``,
``tx_frames``, ``tx_frames_fused``).  ``path`` selects the modulator:

* ``None``    -> ``ops.ofdm.modulate`` (torch.fft), per frame;
* ``"kernel"`` -> K1 (``kernels.ofdm_mod.modulate_rows``) over the whole
  batch's symbols as one row axis (rows normalise independently);
* ``"fused"``  -> :func:`tx_frames_fused`, grid-free through K1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import ofdm_mod
from ..ops import modulation, ofdm
from ..ops.zadoff_chu import zc_for_config
from ..utils.params import OFDMConfig, used_bins
from ..utils.tables import device_table


def _grid(cfg: OFDMConfig, bits: torch.Tensor) -> torch.Tensor:
    """[..., num_bits] -> [..., num_ofdm_symb, nfft] resource grid."""
    pts = modulation.bits_to_symbols(bits, cfg.modulation)
    return ofdm.resource_grid(cfg, pts.reshape(
        *bits.shape[:-1], cfg.num_data_symb, cfg.num_data_only_bins))


def tx_frames(cfg: OFDMConfig, bits: torch.Tensor,
              path: str | None = None) -> torch.Tensor:
    """[B, num_bits] bits -> [B, frame_len] complex64 frames."""
    if path == "fused":
        return tx_frames_fused(cfg, bits)
    grids = _grid(cfg, bits)
    if path is None:
        return ofdm.modulate(cfg, grids)
    if path != "kernel":
        raise ValueError(f"unknown TX path {path!r}")
    rows = ofdm_mod.modulate_rows(cfg, grids.reshape(-1, cfg.nfft))
    return rows.reshape(bits.shape[0], cfg.frame_len)


def tx_frame(cfg: OFDMConfig, bits: torch.Tensor,
             path: str | None = None) -> torch.Tensor:
    """[num_bits] bits -> [frame_len] complex64 time samples."""
    return tx_frames(cfg, bits[None], path)[0]


@functools.lru_cache(maxsize=16)
def _synch_time_rows(cfg: OFDMConfig) -> np.ndarray:
    """The m_synch distinct synch symbols as constant normalised time rows
    [m_synch, nfft+cp] (``txofdm._synch_time_rows``)."""
    _, sb = used_bins(cfg.nfft, cfg.num_synch_bins)
    zc = np.asarray(zc_for_config(cfg))
    seg = cfg.num_synch_bins
    rows = []
    for m in range(cfg.m_synch):
        g = np.zeros(cfg.nfft, complex)
        g[np.asarray(sb)] = zc[m * seg:(m + 1) * seg]
        x = np.fft.ifft(g, cfg.nfft)
        t = np.concatenate([x[-cfg.cp_len:], x])
        e = float(np.sum(np.abs(t) ** 2))
        if e > 1e-30:
            t = t * np.sqrt(len(t) / e)
        t = t / np.sqrt(np.var(t))
        rows.append(t.astype(np.complex64))
    return np.stack(rows)


def tx_frames_fused(cfg: OFDMConfig, bits: torch.Tensor) -> torch.Tensor:
    """Grid-free batched TX: data values go straight through K1 with the
    bins-restricted IDFT, and the synch symbols are constant rows
    (``txofdm.tx_frames_fused``).  bits [B, num_bits] -> [B, frame_len]."""
    if cfg.pilot_grid != "none":
        raise NotImplementedError("pilot grids are not ported yet")
    b = bits.shape[0]
    _, data_bins = used_bins(cfg.nfft, cfg.num_data_bins)
    pts = modulation.bits_to_symbols(bits, cfg.modulation).reshape(
        b * cfg.num_data_symb, cfg.num_data_bins)
    rows = ofdm_mod.modulate_data_vals(cfg, pts, data_bins)
    d = rows.reshape(b, cfg.num_patterns, cfg.synch_dat[1], cfg.rx_b_len)
    s = device_table(_synch_time_rows, bits.device, cfg)
    s = s.expand(b, cfg.num_patterns, cfg.m_synch, cfg.rx_b_len)
    return torch.cat([s, d], 2).reshape(b, cfg.frame_len)
