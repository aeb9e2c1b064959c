"""Physical-layer-security (PLS) ops in torch: the DFT codebook, random
unitaries, a closed-form batched 2x2 complex SVD, PMI estimation, and the
precoded OFDM TX / RX with its timing lock.

Port of ``lte_gnu_radio_code_tpu/ops/pls.py`` (``random_unitary``,
``svd2x2``, ``pmi_estimate``, ``bits_to_precoders``, ``rotated_precoder``,
``transmit``, ``receive``, ``_synch_freq``, ``sync_lock``,
``receive_synced``); its docstrings cite the reference
(TEST/GNU_RADIO_OFFLINE/pls_aio.py).  Every function takes leading
exchange axes: precoders [..., S, SB, n, n], time buffers [..., n_ant, T].
The constant tables (codebook, synch mask, reference symbols) come from
the port's ``reference_cpu/pls.py``, as the JAX module takes them from its
own; they and the sync search's windows are made once per device with
``device_table``.
Nothing here reaches a kernel: the JAX package runs PLS in plain XLA, and
the sizes are tiny (nfft 64, 2 antennas, 4 x 2 matrices of 2 x 2).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..reference_cpu import pls as pls_ref
from ..utils.params import PLSConfig
from ..utils.tables import device_table
from . import sync


# -- constant tables (numpy; reference_cpu/pls.py) ---------------------------

@functools.lru_cache(maxsize=8)
def _codebook(cfg: PLSConfig) -> np.ndarray:
    return pls_ref.codebook(cfg).astype(np.complex64)


_synch_mask = functools.lru_cache(maxsize=8)(pls_ref.synch_mask)
_ref_signal = functools.lru_cache(maxsize=8)(pls_ref.ref_signal)


def _ref64(cfg: PLSConfig) -> np.ndarray:
    return _ref_signal(cfg).astype(np.complex64)


def _mask64(cfg: PLSConfig) -> np.ndarray:
    return _synch_mask(cfg).astype(np.complex64)


def _rows(cfg: PLSConfig, kind: int) -> np.ndarray:
    return np.where(np.asarray(cfg.symbol_pattern()) == kind)[0].astype(
        np.int64)


def _data_bins(cfg: PLSConfig) -> np.ndarray:
    return np.asarray(cfg.used_data_bins(), np.int64)


def _synch_bins(cfg: PLSConfig) -> np.ndarray:
    return np.asarray(cfg.used_synch_bins(), np.int64)


def _bit_shifts(cfg: PLSConfig) -> np.ndarray:
    return np.arange(cfg.bit_codebook - 1, -1, -1, dtype=np.int64)


# -- unitaries, SVD, codebook ------------------------------------------------

def random_unitary(generator: torch.Generator, shape, n: int) -> torch.Tensor:
    """[*shape, n, n] complex64 unitaries on the generator's device: QR of
    uniform(0,1) + j uniform(0,1) with the R-diagonal phase fix, which
    makes Q unique for a given matrix (pls_aio.py:236-249)."""
    dev = generator.device
    re = torch.rand(*shape, n, n, generator=generator, device=dev)
    im = torch.rand(*shape, n, n, generator=generator, device=dev)
    return unitary_of(torch.complex(re, im))


def unitary_of(m: torch.Tensor) -> torch.Tensor:
    """The phase-fixed Q of m's QR (``random_unitary``'s construction)."""
    q, r = torch.linalg.qr(m)
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    return q * (d / d.abs())[..., None, :]


def svd2x2(a: torch.Tensor):
    """Closed-form SVD of [..., 2, 2] complex matrices
    (``pls.py:svd2x2``): (u, s, v) with a = u diag(s) v^H, s descending,
    u's and v's columns phase-normalised on their first row
    (pls_aio.py:536-543).  From the Hermitian eigenproblem of a^H a, with
    the JAX function's thresholds and branch order."""
    b = a.conj().transpose(-1, -2) @ a
    alpha, gamma, beta = b[..., 0, 0].real, b[..., 1, 1].real, b[..., 0, 1]
    tr, dif = alpha + gamma, alpha - gamma
    rad = torch.sqrt(dif * dif + 4.0 * beta.abs() ** 2)
    l1 = (tr + rad) / 2.0
    l2 = ((tr - rad) / 2.0).clamp_min(0.0)
    s1 = torch.sqrt(l1.clamp_min(0.0))
    s2 = torch.sqrt(l2)

    # eigenvector of b for l1; the axis vectors where b is diagonal
    one, zero = torch.ones_like(beta), torch.zeros_like(beta)
    off = beta.abs() > 1e-12 * tr.clamp_min(1e-30)
    v11 = torch.where(off, beta, torch.where(dif >= 0, one, zero))
    v21 = torch.where(off, (l1 - alpha).to(beta.dtype),
                      torch.where(dif >= 0, zero, one))
    nrm = torch.sqrt(v11.abs() ** 2 + v21.abs() ** 2)
    v11, v21 = v11 / nrm, v21 / nrm
    v = torch.stack([torch.stack([v11, -v21.conj()], -1),
                     torch.stack([v21, v11.conj()], -1)], -2)

    def unit(x):
        n = torch.sqrt((x.abs() ** 2).sum(-1, keepdim=True))
        return x / n.clamp_min(1e-30), n

    u1, _ = unit((a @ v[..., :, 0:1])[..., 0])
    u2_raw, u2n = unit((a @ v[..., :, 1:2])[..., 0])
    # sigma2 ~ 0: the orthogonal complement of u1 instead
    u2_ortho = torch.stack([-u1[..., 1].conj(), u1[..., 0].conj()], -1)
    tiny = (u2n[..., 0] < 1e-6 * s1.clamp_min(1e-30))[..., None]
    u = torch.stack([u1, torch.where(tiny, u2_ortho, u2_raw)], -1)

    def phase_norm(m):
        return m * torch.exp(-1j * torch.angle(m[..., 0:1, :]))

    return phase_norm(u), torch.stack([s1, s2], -1), phase_norm(v)


def pmi_estimate(cfg: PLSConfig, rx_precoder: torch.Tensor):
    """Least Frobenius distance to the codebook (pls_aio.py:546-577):
    rx_precoder [..., S, SB, n, n] -> (pmi [..., S, SB], bits
    [..., S*SB*bit_codebook], MSB first)."""
    dev = rx_precoder.device
    cb = device_table(_codebook, dev, cfg)
    dist = ((rx_precoder[..., None, :, :] - cb).abs() ** 2).sum((-2, -1))
    pmi = dist.argmin(-1)
    bits = (pmi[..., None] >> device_table(_bit_shifts, dev, cfg)) & 1
    return pmi, bits.reshape(*rx_precoder.shape[:-4], -1).to(torch.int32)


def bits_to_precoders(cfg: PLSConfig, bits: torch.Tensor) -> torch.Tensor:
    """Key bits [..., S*SB*bit_codebook] -> [..., S, SB, n, n] codebook
    precoders (pls_aio.py:251-291)."""
    dev = bits.device
    b = bits.reshape(*bits.shape[:-1], cfg.num_data_symb, cfg.num_subbands,
                     cfg.bit_codebook).to(torch.int64)
    idx = (b << device_table(_bit_shifts, dev, cfg)).sum(-1)
    return device_table(_codebook, dev, cfg)[idx]


def rotated_precoder(rotation: torch.Tensor, dft: torch.Tensor
                     ) -> torch.Tensor:
    """conj(U) @ conj(F)^T per symbol and subband (pls_aio.py:293-307)."""
    return torch.einsum("...ab,...cb->...ac", rotation.conj(), dft.conj())


# -- TX / RX -------------------------------------------------------------------

def transmit(cfg: PLSConfig, precoders: torch.Tensor) -> torch.Tensor:
    """Precoders [..., S, SB, n, n] -> [..., n_ant, frame_len] time buffer
    (``pls.py:transmit``): subband sb's precoder columns on its bins, times
    the reference symbols, IDFT, cyclic prefix, one joint scale per symbol
    over both antennas (a per-antenna scale would break the SVD's
    reciprocity), into the synch mask's data rows."""
    dev = precoders.device
    S, n, sbs = cfg.num_data_symb, cfg.num_ant, cfg.subband_size
    lead = precoders.shape[:-4]
    fbin = precoders.transpose(-1, -2).reshape(
        *lead, S, cfg.num_subbands * sbs, n).transpose(-1, -2)  # [.., S, n, B]
    fbin = fbin * device_table(_ref64, dev, cfg)[:, None, :]
    grid = fbin.new_zeros(*lead, S, n, cfg.nfft)
    grid[..., device_table(_data_bins, dev, cfg)] = fbin
    t = torch.fft.ifft(grid, cfg.nfft, dim=-1)
    t = torch.cat([t[..., -cfg.cp_len:], t], -1)          # [..., S, n, len]
    p = ((t - t.mean(-1, keepdim=True)).abs() ** 2).mean(-1).sum(-1)
    t = t / torch.sqrt(p)[..., None, None]
    mask = device_table(_mask64, dev, cfg)
    buf = mask.reshape(n, cfg.total_num_symb, cfg.symb_len).expand(
        *lead, n, cfg.total_num_symb, cfg.symb_len).clone()
    buf[..., device_table(_rows, dev, cfg, 1), :] = t.transpose(-3, -2)
    return buf.reshape(*lead, n, cfg.frame_len)


def receive(cfg: PLSConfig, rx_time: torch.Tensor):
    """[..., n_ant, frame_len] -> (lsv, sval, rsv, bits) per subband
    (``pls.py:receive``): CP-strip the data symbols at perfect timing, LS
    estimate against the references, [S, SB, n_rx, sbs] matrices, SVD,
    PMI of the right singular vectors."""
    dev = rx_time.device
    n = cfg.num_ant
    lead = rx_time.shape[:-2]
    sym = rx_time.reshape(*lead, n, cfg.total_num_symb, cfg.symb_len)
    data = sym[..., device_table(_rows, dev, cfg, 1), cfg.cp_len:]
    f = torch.fft.fft(data, cfg.nfft, dim=-1)              # [..., n, S, N]
    est = f[..., device_table(_data_bins, dev, cfg)] * \
        device_table(_ref64, dev, cfg).conj()
    est = est.transpose(-3, -2).reshape(*lead, cfg.num_data_symb, n,
                                        cfg.num_subbands, cfg.subband_size)
    lsv, sval, rsv = svd2x2(est.transpose(-3, -2))
    _, bits = pmi_estimate(cfg, rsv)
    return lsv, sval, rsv, bits


# -- timing lock on the frame's ZC synch symbols --------------------------------
#
# The reference's PLS receive assumes perfect timing (pls_aio.py:427-457);
# the JAX package completes it with a delay search over the frame's own synch
# symbols (ops/pls.py, round 4), ported here.

@functools.lru_cache(maxsize=8)
def _synch_freq(cfg: PLSConfig):
    """(synch rows, owning antenna per row, [S0, nfft] complex64 known
    spectrum of each synch symbol), from the synch mask."""
    sym = _synch_mask(cfg).reshape(cfg.num_ant, cfg.total_num_symb,
                                   cfg.symb_len)
    synch_rows = _rows(cfg, 0)
    f = np.fft.fft(sym[:, synch_rows, cfg.cp_len:], cfg.nfft, axis=-1)
    own = np.argmax(np.sum(np.abs(f), axis=-1), axis=0)
    freq = f[own, np.arange(len(synch_rows))]
    return synch_rows, own, freq.astype(np.complex64)


def _sync_windows(cfg: PLSConfig, max_delay: int) -> np.ndarray:
    """[D, S0, nfft] int64: the CP-stripped synch windows of every delay
    hypothesis d in 0..max_delay."""
    starts = _synch_freq(cfg)[0] * cfg.symb_len + cfg.cp_len
    return (starts[None, :, None] + np.arange(max_delay + 1)[:, None, None] +
            np.arange(cfg.nfft)[None, None, :])


def _synch_ref(cfg: PLSConfig) -> np.ndarray:
    """[S0, L]: conj of each synch symbol's spectrum on the synch bins."""
    return np.conj(_synch_freq(cfg)[2][:, _synch_bins(cfg)])


def sync_lock(cfg: PLSConfig, rx_time: torch.Tensor,
              max_delay: int) -> torch.Tensor:
    """Integer-delay timing search (``pls.py:sync_lock``): rx_time
    [..., n_ant, >= frame_len + max_delay] -> the delay [...] int64 whose
    synch windows correlate best with the known ZC spectra, the metric
    summing |corr| over synch symbols and RX antennas (each TX antenna's
    ZC reaches every RX antenna); ties go to the first."""
    if rx_time.shape[-1] < cfg.frame_len + max_delay:
        raise ValueError(f"sync_lock: {rx_time.shape[-1]} samples, the "
                         f"search reads {cfg.frame_len + max_delay}")
    dev = rx_time.device
    win = rx_time[..., device_table(_sync_windows, dev, cfg, max_delay)]
    f = torch.fft.fft(win, cfg.nfft, dim=-1)[
        ..., device_table(_synch_bins, dev, cfg)]      # [..., r, D, S0, L]
    corr = torch.einsum("...rdsb,sb->...rds", f,
                        device_table(_synch_ref, dev, cfg))
    return corr.abs().sum((-3, -1)).argmax(-1)


@functools.lru_cache(maxsize=8)
def _frame_offsets(cfg: PLSConfig) -> np.ndarray:
    return np.arange(cfg.frame_len, dtype=np.int64)


def receive_synced(cfg: PLSConfig, rx_time: torch.Tensor, max_delay: int):
    """:func:`receive` behind the timing lock (``pls.py:receive_synced``):
    the frame cut at the locked delay.  Returns (lsv, sval, rsv, bits,
    lock_ptr)."""
    ptr = sync_lock(cfg, rx_time, max_delay)
    x = sync.windows_at(rx_time, ptr[..., None].expand(rx_time.shape[:-1]),
                        device_table(_frame_offsets, rx_time.device, cfg))
    return (*receive(cfg, x), ptr)
