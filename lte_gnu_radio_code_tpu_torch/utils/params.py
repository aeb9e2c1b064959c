"""OFDM numerology for the PyTorch port.

The subset of ``lte_gnu_radio_code_tpu/utils/params.py`` that the loopback
chain needs: :class:`OFDMConfig` with the same fields and derived values,
:func:`used_bins`, and the three shipped configurations.  It is a copy, not
an import, so that the port loads nothing of the JAX package;
``tests/test_torch_tables.py`` pins every field and derived value equal to
the JAX module's.  Pilot grids are not ported yet: a config that asks for
one raises where the pilot plan would be needed.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class OFDMConfig:
    """One OFDM TX/RX scenario (``utils/params.py:OFDMConfig`` in the JAX
    package; field meanings and reference citations are documented there)."""

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
    num_ant_txrx: int = 1
    bin_spacing: float = 15e3
    channel_band: float = 0.97 * 960e3
    pilot_grid: str = "none"
    ref_sigs: float = 0.0
    pilot_spacing: int = 6
    pilot_seed: int = 7

    @property
    def rx_b_len(self) -> int:
        return self.nfft + self.cp_len

    @property
    def m_synch(self) -> int:
        return self.synch_dat[0]

    @property
    def n_data_per_pattern(self) -> int:
        return self.synch_dat[1]

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
    def num_pilot_bins(self) -> int:
        if self.pilot_grid == "none":
            return 0
        raise NotImplementedError("pilot grids are not ported yet")

    @property
    def num_data_only_bins(self) -> int:
        return self.num_data_bins - self.num_pilot_bins

    @property
    def num_bits(self) -> int:
        return self.num_data_symb * self.num_data_only_bins * self.bits_per_bin

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

    @property
    def fs(self) -> float:
        return self.bin_spacing * self.nfft

    def symbol_pattern(self) -> Tuple[int, ...]:
        """0 = synch symbol, 1 = data symbol."""
        base = (0,) * self.synch_dat[0] + (1,) * self.synch_dat[1]
        return base * self.num_patterns

    def validate(self) -> "OFDMConfig":
        if self.num_ofdm_symb % self.pattern_len:
            raise ValueError(
                "num_ofdm_symb must be a whole number of synch/data patterns")
        if self.num_synch_bins % 2 or self.num_synch_bins > self.nfft - 2:
            raise ValueError("num_synch_bins must be even and <= nfft-2")
        if self.num_data_bins % 2 or self.num_data_bins > self.nfft - 2:
            raise ValueError("num_data_bins must be even and <= nfft-2")
        return self


def used_bins(nfft: int, num_bins: int
              ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Signed bins around DC (no DC, no Nyquist) and their wrapped FFT
    indices (``utils/params.py:used_bins``)."""
    neg = list(range(-(num_bins // 2), 0))
    pos = list(range(1, num_bins // 2 + 1))
    signed = tuple(neg + pos)
    wrapped = tuple((nfft + b) % nfft for b in signed)
    return signed, wrapped


GOLDEN64 = OFDMConfig().validate()
LTE1024 = OFDMConfig(
    nfft=1024, cp_len=256, num_ofdm_symb=64, synch_dat=(1, 3),
    num_data_bins=960, num_synch_bins=1022, bin_spacing=15e3,
    stride=255, channel_band=15e3 * 960).validate()
LTE2048 = OFDMConfig(
    nfft=2048, cp_len=512, num_ofdm_symb=64, synch_dat=(1, 3),
    num_data_bins=1200, num_synch_bins=2046, bin_spacing=15e3,
    stride=511, channel_band=15e3 * 1200).validate()
