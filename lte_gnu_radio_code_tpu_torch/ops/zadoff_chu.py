"""Zadoff-Chu synchronisation sequences and the delay-search phase matrix
(numpy constants; copy of ``ops/zadoff_chu.py`` in the JAX package, pinned
equal to it by ``tests/test_torch_tables.py``)."""

from __future__ import annotations

import numpy as np

from ..utils.params import OFDMConfig, used_bins


def zadoff_chu(mm: int, prime: int, parity_even: bool | None = None
               ) -> np.ndarray:
    if parity_even is None:
        parity_even = mm % 2 == 0
    n = np.arange(mm, dtype=np.float64)
    phase = n * n if parity_even else n * (n + 1)
    return np.exp(-1j * (2.0 * np.pi / mm) * prime * phase / 2.0
                  ).astype(np.complex64)


def zc_for_config(cfg: OFDMConfig) -> np.ndarray:
    if cfg.zc_parity_on == "mm":
        parity_even = cfg.mm % 2 == 0
    else:
        parity_even = cfg.num_synch_bins % 2 == 0
    return zadoff_chu(cfg.mm, cfg.zc_prime, parity_even)


def delay_search_matrix(cfg: OFDMConfig) -> np.ndarray:
    """[cp_len+1, m_synch*num_synch_bins] phase hypotheses exp(+j2pi d b/N)."""
    _, bins_p = used_bins(cfg.nfft, cfg.num_synch_bins)
    base = np.exp((1j * 2.0 * np.pi / cfg.nfft) *
                  np.outer(np.arange(cfg.cp_len + 1), np.asarray(bins_p)))
    return np.tile(base, (1, cfg.m_synch)).astype(np.complex64)
