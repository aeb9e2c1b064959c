"""Bit <-> symbol mapping and the reference's QPSK LLR demap, in torch.

Port of ``lte_gnu_radio_code_tpu/ops/modulation.py`` (``bits_to_symbols``
for BPSK/QPSK, ``qpsk_llr``).  QAM mapping and the max-log demap are not
ported yet.
"""

from __future__ import annotations

import torch

_K = 0.7071067811865476           # |re| = |im| of every QPSK point
_SQRT2 = 1.414213562373095


def bits_to_symbols(bits: torch.Tensor, modulation: str) -> torch.Tensor:
    """[..., n*bits_per_symbol] int bits -> [..., n] complex64 points
    (``modulation.py:bits_to_symbols``; QPSK in its arithmetic form,
    re sign from the MSB, im sign from the LSB)."""
    if modulation == "BPSK":
        return (2.0 * bits.to(torch.float32) - 1.0).to(torch.complex64)
    if modulation == "QPSK":
        b = bits.reshape(*bits.shape[:-1], -1, 2).to(torch.float32)
        return torch.complex((1.0 - 2.0 * b[..., 0]) * _K,
                             (1.0 - 2.0 * b[..., 1]) * _K)
    raise NotImplementedError(f"{modulation} mapping is not ported yet")


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
