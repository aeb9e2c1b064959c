"""Bit <-> symbol mapping and soft demapping, in torch.

Port of ``lte_gnu_radio_code_tpu/ops/modulation.py``: ``bits_to_symbols``
(BPSK, QPSK, Gray-mapped square QAM16 / QAM64), the reference's QPSK LLR
demap ``qpsk_llr`` and its pair-swapped variant ``qpsk_llr_pairswap``, and
the max-log demap ``maxlog_llr`` for any modulation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.tables import device_table

_K = 0.7071067811865476           # |re| = |im| of every QPSK point
_SQRT2 = 1.414213562373095

QPSK_POINTS = np.exp(1j * 2.0 * np.pi / 8.0 *
                     np.array([1.0, -1.0, 3.0, 5.0])).astype(np.complex64)
BITS_PER_SYMBOL = {"BPSK": 1, "QPSK": 2, "QAM16": 4, "QAM64": 6}


def _gray_qam_constellation(bits_per_axis: int) -> np.ndarray:
    """Gray-mapped PAM levels of one axis, indexed by the bit pattern, at
    unit average power per complex symbol
    (``modulation.py:_gray_qam_constellation``)."""
    m = 1 << bits_per_axis
    levels = np.arange(m)
    gray = levels ^ (levels >> 1)
    pos = np.empty(m, dtype=np.int64)     # place of each codeword on the axis
    pos[gray] = levels
    amp = 2 * pos - (m - 1)
    scale = np.sqrt(2.0 * (m * m - 1) / 3.0)
    return (amp / scale).astype(np.float32)


QAM16_PAM = _gray_qam_constellation(2)   # indexed by 2-bit pattern
QAM64_PAM = _gray_qam_constellation(3)   # indexed by 3-bit pattern


def _pam(modulation: str) -> np.ndarray:
    return QAM16_PAM if modulation == "QAM16" else QAM64_PAM


def bits_to_symbols(bits: torch.Tensor, modulation: str) -> torch.Tensor:
    """[..., n*bits_per_symbol] int bits -> [..., n] complex64 points
    (``modulation.py:bits_to_symbols``; QPSK in its arithmetic form,
    re sign from the MSB, im sign from the LSB; QAM as a gather from the
    PAM table, the first half of a symbol's bits the real axis)."""
    if modulation == "BPSK":
        return (2.0 * bits.to(torch.float32) - 1.0).to(torch.complex64)
    if modulation == "QPSK":
        b = bits.reshape(*bits.shape[:-1], -1, 2).to(torch.float32)
        return torch.complex((1.0 - 2.0 * b[..., 0]) * _K,
                             (1.0 - 2.0 * b[..., 1]) * _K)
    if modulation in ("QAM16", "QAM64"):
        k = BITS_PER_SYMBOL[modulation] // 2
        pam = device_table(_pam, bits.device, modulation)
        b = bits.reshape(*bits.shape[:-1], -1, 2 * k).to(torch.int64)
        w = 2 ** torch.arange(k - 1, -1, -1, device=bits.device)
        return torch.complex(pam[(b[..., :k] * w).sum(-1)],
                             pam[(b[..., k:] * w).sum(-1)])
    raise ValueError(modulation)


def _qpsk_llr_rows(d: torch.Tensor):
    """[F, n] phasors, one frame per row -> (hard, llr0, llr1), each
    [F, 2n]; sigma is a mean over each row only."""
    re, im = d.real, d.imag
    re_pos, im_pos = re >= 0, im >= 0
    # nearest point by quadrant; sign(0) -> + matches argmin's first-index
    # tie-break over the reference's table order
    ezr = re - torch.where(re_pos, _K, -_K)
    ezi = im - torch.where(im_pos, _K, -_K)
    dmin = torch.hypot(ezr, ezi)
    sigma = _K * dmin.mean(-1, keepdim=True)
    dfact = 1.0 / (sigma * sigma)
    er, ei = ezr.abs(), ezi.abs()
    near_r, far_r = -0.5 * dfact * er, -0.5 * dfact * (_SQRT2 - er)
    near_i, far_i = -0.5 * dfact * ei, -0.5 * dfact * (_SQRT2 - ei)
    rows = d.shape[0]
    llr0 = torch.stack([torch.where(re_pos, near_r, far_r),
                        torch.where(im_pos, near_i, far_i)], -1
                       ).reshape(rows, -1)
    llr1 = torch.stack([torch.where(re_pos, far_r, near_r),
                        torch.where(im_pos, far_i, near_i)], -1
                       ).reshape(rows, -1)
    hard = (0.5 * (torch.sign(llr1 - llr0) + 1.0)).to(torch.int32)
    return hard, llr0, llr1


def qpsk_llr(phasors: torch.Tensor):
    """One frame's phasors (any shape) -> (hard_bits [2n], llr0, llr1)
    (``modulation.py:qpsk_llr``).  Index 2k is the real-rail (MSB) bit of
    symbol k, 2k+1 the imaginary rail."""
    hard, llr0, llr1 = _qpsk_llr_rows(phasors.reshape(1, -1))
    return hard[0], llr0[0], llr1[0]


def qpsk_llr_frames(phasors: torch.Tensor):
    """[F, ...] phasors of F frames -> (hard, llr0, llr1), each [F, 2n]:
    ``qpsk_llr`` per frame, as ``jax.vmap(qpsk_llr)`` computes it."""
    return _qpsk_llr_rows(phasors.reshape(phasors.shape[0], -1))


def qpsk_llr_pairswap(phasors: torch.Tensor):
    """The per-stream Bit_Recovery variant's demap
    (``modulation.py:qpsk_llr_pairswap``): rail near/far picked by the
    other axis's sign, soft bits pair-swapped into the output, ceil
    tie-break.  Returns (hard_bits [2n] int32, llr0 [2n], llr1 [2n])."""
    d = phasors.reshape(-1)
    re_pos, im_pos = d.real >= 0, d.imag >= 0
    ezr = d.real - torch.where(re_pos, _K, -_K)
    ezi = d.imag - torch.where(im_pos, _K, -_K)
    sigma0 = float(np.sqrt(0.5)) * torch.hypot(ezr, ezi).mean()
    dfact = 1.0 / (sigma0 * sigma0)
    er, ei = ezr.abs(), ezi.abs()
    near_r, far_r = -0.5 * er, -0.5 * (_SQRT2 - er)
    near_i, far_i = -0.5 * ei, -0.5 * (_SQRT2 - ei)
    rail_r0 = torch.where(im_pos, near_r, far_r) * dfact
    rail_r1 = torch.where(im_pos, far_r, near_r) * dfact
    rail_i0 = torch.where(re_pos, near_i, far_i) * dfact
    rail_i1 = torch.where(re_pos, far_i, near_i) * dfact
    # pair swap: even outputs <- imaginary rail, odd <- real rail
    llr0 = torch.stack([rail_i0, rail_r0], 1).reshape(-1)
    llr1 = torch.stack([rail_i1, rail_r1], 1).reshape(-1)
    hard = torch.ceil(0.5 * (torch.sign(llr1 - llr0) + 1.0)).to(torch.int32)
    return hard, llr0, llr1


@functools.lru_cache(maxsize=None)
def _constellation_table(modulation: str) -> tuple[np.ndarray, np.ndarray]:
    """(points [M] complex64, bit table [M, bps] int32) of a modulation,
    point i carrying the bits of i, MSB first
    (``modulation.py:_constellation_table``)."""
    bps = BITS_PER_SYMBOL[modulation]
    m = 1 << bps
    idx = np.arange(m)
    bit_tbl = ((idx[:, None] >> np.arange(bps - 1, -1, -1)) & 1
               ).astype(np.int32)
    pts = np.zeros(m, dtype=np.complex64)
    for i in range(m):
        b = bit_tbl[i].astype(np.float32)
        if modulation == "BPSK":
            pts[i] = 2 * b[0] - 1
        elif modulation == "QPSK":
            pts[i] = QPSK_POINTS[int(2 * b[0] + b[1])]
        else:
            k = bps // 2
            pam = _pam(modulation)
            w = 2 ** np.arange(k - 1, -1, -1)
            pts[i] = (pam[int((b[:k] * w).sum())] +
                      1j * pam[int((b[k:] * w).sum())])
    return pts, bit_tbl


def _points(modulation: str) -> np.ndarray:
    return _constellation_table(modulation)[0]


def _bit_is_one(modulation: str) -> np.ndarray:
    """[bps, M] int32: 1 where point m carries a 1 in bit b."""
    return np.ascontiguousarray(_constellation_table(modulation)[1].T)


def maxlog_llr(phasors: torch.Tensor, modulation: str, noise_var):
    """Max-log LLRs for any supported modulation
    (``modulation.py:maxlog_llr``): phasors of any shape -> (hard_bits
    [n*bps] int32, llr [n*bps]), llr > 0 meaning bit = 1.  The table form:
    the squared distance of every symbol to every point, [n, M], and for
    each bit the least distance among the points that carry a 1 and among
    those that carry a 0."""
    dev = phasors.device
    pts = device_table(_points, dev, modulation)
    is1 = device_table(_bit_is_one, dev, modulation) == 1       # [bps, M]
    d = phasors.reshape(-1)
    dist = (d[:, None] - pts).abs() ** 2                        # [n, M]
    big = torch.full((), 1e30, dtype=dist.dtype, device=dev)
    llrs = []
    for b in range(is1.shape[0]):
        d1 = torch.where(is1[b], dist, big).amin(1)
        d0 = torch.where(is1[b], big, dist).amin(1)
        llrs.append((d0 - d1) / noise_var)
    llr = torch.stack(llrs, 1).reshape(-1)
    return (llr > 0).to(torch.int32), llr
