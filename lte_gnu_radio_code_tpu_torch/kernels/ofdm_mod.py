"""K1: the fused OFDM modulator — rows of bin values through an IDFT basis,
cyclic-prefix prepend and the reference's two-stage per-symbol power
normalisation.

Port of ``lte_gnu_radio_code_tpu/pallas_kernels/ofdm_mod.py``
(``_mod_rows_planar`` and its entry points ``modulate_planar``,
``modulate_rows``, ``modulate_data_vals``).  On a CUDA tensor
the wrapper launches ``csrc/ofdm_mod.cu``; on a CPU tensor it runs the plain
twin :func:`mod_rows_plain`.  One kernel serves both bases: the full
``[nfft, nfft]`` IDFT and the ``[K, nfft]`` IDFT restricted to the data bins.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.params import OFDMConfig
from ..utils.tables import device_table
from . import _cuda

launches = 0          # kernel launches since the last reset


@functools.lru_cache(maxsize=16)
def _idft_mats(nfft: int) -> np.ndarray:
    """[nfft, nfft] IDFT matrix e^{+2pi i kn/N}/N (``ofdm_mod._idft_mats``)."""
    n = np.arange(nfft)
    return (np.exp(2j * np.pi * np.outer(n, n) / nfft) / nfft
            ).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _idft_bin_mats(nfft: int, bins: tuple) -> np.ndarray:
    """[K, nfft] IDFT restricted to bin positions
    (``ofdm_mod._idft_bin_mats``)."""
    n = np.arange(nfft)
    return (np.exp(2j * np.pi * np.outer(np.asarray(bins), n) / nfft) / nfft
            ).astype(np.complex64)


def _cp_normalise(cfg: OFDMConfig, x: torch.Tensor) -> torch.Tensor:
    """[S, nfft] -> [S, nfft+cp]: the Pallas kernel's last step
    (``ofdm_mod._kernel._finish``), floors included."""
    t = torch.cat([x[:, cfg.nfft - cfg.cp_len:], x], 1)
    n_t = t.shape[1]
    tr, ti = t.real, t.imag
    energy = (tr * tr + ti * ti).sum(1, keepdim=True)
    scale = torch.where(energy > 1e-30,
                        torch.rsqrt(energy.clamp_min(1e-30) / n_t), 1.0)
    tr, ti = tr * scale, ti * scale
    mr, mi = tr.mean(1, keepdim=True), ti.mean(1, keepdim=True)
    p = ((tr - mr) ** 2 + (ti - mi) ** 2).mean(1, keepdim=True)
    inv = torch.rsqrt(p.clamp_min(1e-30))
    return torch.complex(tr * inv, ti * inv)


def mod_rows_plain(cfg: OFDMConfig, rows: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Plain twin of K1: [S, K] rows @ [K, nfft] basis -> [S, nfft+cp]."""
    _cuda.require_fp32(rows.device)
    return _cp_normalise(cfg, rows @ w)


def _mod_rows(cfg: OFDMConfig, rows: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    global launches
    if _cuda.on_cpu(rows, w):
        return mod_rows_plain(cfg, rows, w)
    s, k = rows.shape
    _cuda.check(rows, "rows", torch.complex64, (s, k))
    _cuda.check(w, "basis", torch.complex64, (k, cfg.nfft))
    out = torch.empty(s, cfg.rx_b_len, dtype=torch.complex64,
                      device=rows.device)
    if s:
        _cuda.launch("ofdm_mod_rows", rows.device, rows.data_ptr(),
                     w.data_ptr(), out.data_ptr(), s, k, cfg.nfft,
                     cfg.cp_len)
        launches += 1
    return out


def modulate_rows(cfg: OFDMConfig, grid: torch.Tensor) -> torch.Tensor:
    """[S, nfft] complex grid -> [S, nfft+cp] complex time symbols."""
    w = device_table(_idft_mats, grid.device, cfg.nfft)
    return _mod_rows(cfg, grid.to(torch.complex64).contiguous(), w)


def modulate_planar(cfg: OFDMConfig, grid_re: torch.Tensor,
                    grid_im: torch.Tensor):
    """[S, nfft] re/im grid -> ([S, nfft+cp] re, im) time symbols."""
    out = modulate_rows(cfg, torch.complex(grid_re.float(), grid_im.float()))
    return out.real.contiguous(), out.imag.contiguous()


def modulate_data_vals(cfg: OFDMConfig, vals: torch.Tensor,
                       bins) -> torch.Tensor:
    """Grid-free modulate: [S_d, K] data values (K bins in used_bins order)
    -> [S_d, nfft+cp] time symbols through the bins-restricted IDFT."""
    w = device_table(_idft_bin_mats, vals.device, cfg.nfft,
                     tuple(int(b) for b in bins))
    return _mod_rows(cfg, vals.to(torch.complex64).contiguous(), w)
