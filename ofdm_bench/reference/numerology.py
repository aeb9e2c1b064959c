"""The OFDM numerology the reference computes with, made from a
configuration file's keywords alone.

A frozen copy of the fields and derived values that ``reference/golden.py``
reads (the reference's own, so that it loads nothing of the program):
``RefConfig`` takes the same keywords as the program's ``OFDMConfig`` and
``used_bins`` lists the same bins.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RefConfig:
    nfft: int = 64
    cp_len: int = 16
    num_ofdm_symb: int = 240
    synch_dat: Tuple[int, int] = (1, 3)
    num_data_bins: int = 60
    num_synch_bins: int = 62
    zc_prime: int = 23
    zc_parity_on: str = "mm"
    modulation: str = "QPSK"
    snr_db: float = 100.0
    snr_convention: str = "db20"
    detection_gate: float = 0.7
    stride: int = 1
    channel: str = "Fading"
    snr_type: str = "Digital"

    @classmethod
    def from_keywords(cls, kw: dict) -> "RefConfig":
        """The configuration file's ``OFDMConfig`` keywords; keys that only
        the program reads (band, bin spacing, pilots) are left out."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in kw.items() if k in names}
        if "synch_dat" in kw:
            kw["synch_dat"] = tuple(kw["synch_dat"])
        return cls(**kw)

    @property
    def rx_b_len(self) -> int:
        return self.nfft + self.cp_len

    @property
    def m_synch(self) -> int:
        return self.synch_dat[0]

    @property
    def pattern_len(self) -> int:
        return sum(self.synch_dat)

    @property
    def mm(self) -> int:
        return self.synch_dat[0] * self.num_synch_bins

    @property
    def num_patterns(self) -> int:
        return self.num_ofdm_symb // self.pattern_len

    @property
    def num_data_symb(self) -> int:
        return self.num_patterns * self.synch_dat[1]

    @property
    def bits_per_bin(self) -> int:
        return {"BPSK": 1, "QPSK": 2, "QAM16": 4, "QAM64": 6}[self.modulation]

    @property
    def num_bits(self) -> int:
        return self.num_data_symb * self.num_data_bins * self.bits_per_bin

    @property
    def frame_len(self) -> int:
        return self.num_ofdm_symb * self.rx_b_len

    @property
    def snr_linear(self) -> float:
        if self.snr_convention == "db20":
            return 10.0 ** (self.snr_db / 20.0)
        if self.snr_convention == "db10":
            return 10.0 ** (self.snr_db / 10.0)
        return self.snr_db

    def symbol_pattern(self) -> Tuple[int, ...]:
        """0 = synch symbol, 1 = data symbol."""
        base = (0,) * self.synch_dat[0] + (1,) * self.synch_dat[1]
        return base * self.num_patterns


def used_bins(nfft: int, num_bins: int
              ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Signed bins around DC (no DC, no Nyquist) and their wrapped FFT
    indices."""
    neg = list(range(-(num_bins // 2), 0))
    pos = list(range(1, num_bins // 2 + 1))
    signed = tuple(neg + pos)
    wrapped = tuple((nfft + b) % nfft for b in signed)
    return signed, wrapped
