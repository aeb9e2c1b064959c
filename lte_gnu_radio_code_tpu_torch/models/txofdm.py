"""TX model in torch: bits -> constellation -> resource grid -> IDFT + CP +
normalisation -> time frame.

Port of ``lte_gnu_radio_code_tpu/models/txofdm.py`` (``tx_frame``,
``tx_frames``, ``make_tx``), for every modulation and pilot grid.  The
modulator is K1 (``kernels.ofdm_mod.modulate_rows``) over the whole
batch's symbols as one row axis (rows normalise independently): the kernel
on a CUDA tensor, its plain twin on a CPU tensor.
"""

from __future__ import annotations

import functools

import torch

from ..kernels import ofdm_mod
from ..ops import modulation, ofdm
from ..utils.params import OFDMConfig


def _grid(cfg: OFDMConfig, bits: torch.Tensor) -> torch.Tensor:
    """[..., num_bits] -> [..., num_ofdm_symb, nfft] resource grid."""
    pts = modulation.bits_to_symbols(bits, cfg.modulation)
    return ofdm.resource_grid(cfg, pts.reshape(
        *bits.shape[:-1], cfg.num_data_symb, cfg.num_data_only_bins))


def tx_frames(cfg: OFDMConfig, bits: torch.Tensor) -> torch.Tensor:
    """[B, num_bits] bits -> [B, frame_len] complex64 frames."""
    rows = ofdm_mod.modulate_rows(cfg, _grid(cfg, bits).reshape(-1, cfg.nfft))
    return rows.reshape(bits.shape[0], cfg.frame_len)


def tx_frame(cfg: OFDMConfig, bits: torch.Tensor) -> torch.Tensor:
    """[num_bits] bits -> [frame_len] complex64 time samples."""
    return tx_frames(cfg, bits[None])[0]


def make_tx(cfg: OFDMConfig):
    """tx_frame bound to the config (``txofdm.make_tx``)."""
    return functools.partial(tx_frame, cfg)
