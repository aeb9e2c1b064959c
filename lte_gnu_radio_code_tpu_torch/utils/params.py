"""OFDM numerology for the PyTorch port.

A copy of ``lte_gnu_radio_code_tpu/utils/params.py``: :class:`OFDMConfig`
with the same fields and derived values, :func:`used_bins`,
:func:`pilot_bin_plan`, :func:`derive_numerology`,
:func:`config_from_profile` with ``SDR_PROFILES``, :class:`PLSConfig` with
``PLS_PROFILES``, the legacy CFO/DSSS case tables with
:func:`config_from_case`, and the three shipped configurations.  It is a
copy, not an import, so that the port loads nothing of the JAX package;
``tests/test_torch_tables.py`` pins every field, derived value, pilot plan,
profile and case equal to the JAX module's.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np


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
        return len(pilot_bin_plan(self)[0])

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


@functools.lru_cache(maxsize=None)
def pilot_bin_plan(cfg: OFDMConfig):
    """Split the used bins into (pilot_signed, pilot_wrapped, data_signed,
    data_wrapped), each a tuple of ints with the signed lists increasing
    (``utils/params.py:pilot_bin_plan``): "lte" puts a pilot every
    ``pilot_spacing`` used bins plus the upper band edge, "random" draws
    symmetric +/- bins from a generator seeded with ``pilot_seed``."""
    signed, _ = used_bins(cfg.nfft, cfg.num_data_bins)
    all_bins = np.asarray(signed)
    if cfg.pilot_grid == "none":
        pilots = np.asarray([], dtype=np.int64)
    elif cfg.pilot_grid == "lte":
        pos = list(range(0, len(all_bins), cfg.pilot_spacing))
        if (len(all_bins) - 1) not in pos:      # anchor the upper band edge
            pos.append(len(all_bins) - 1)
        pilots = all_bins[np.asarray(pos)]
    elif cfg.pilot_grid == "random":
        rng = np.random.RandomState(cfg.pilot_seed)
        half = cfg.num_data_bins // 2
        size = int(np.floor(cfg.num_data_bins * cfg.ref_sigs / 2))
        ref = np.unique(rng.randint(1, half + 1, size=size))
        pilots = np.sort(np.concatenate((-ref, ref)))
    else:
        raise ValueError(f"unknown pilot_grid {cfg.pilot_grid!r}")
    data_only = np.setdiff1d(all_bins, pilots)

    def wrap(b):
        return tuple(int((cfg.nfft + v) % cfg.nfft) for v in b)

    return (tuple(int(v) for v in pilots), wrap(pilots),
            tuple(int(v) for v in data_only), wrap(data_only))


def derive_numerology(channel_band: float, bin_spacing: float,
                      cp_type: str = "Normal") -> Tuple[int, int, int, float]:
    """(NFFT, cp_len, num_data_bins, fs) from bandwidth and bin spacing
    (``utils/params.py:derive_numerology``).

    Reference: SystemModel.py:34-40 (NFFT = 2^ceil(log2(band/spacing)),
    num_synch_bins = NFFT-2, fs = spacing*NFFT), SDRScript.py:57-58
    (num_bins1 = 4*floor(num_bins0/4) for MIMO alignment) and
    SDRScript.py:96-99 (CP Normal = NFFT/4, Extended = NFFT/4 + NFFT/8).
    """
    num_bins0 = math.floor(channel_band / bin_spacing)
    nfft = 2 ** math.ceil(math.log2(round(channel_band / bin_spacing)))
    num_data_bins = 4 * (num_bins0 // 4)
    if cp_type == "Normal":
        cp_len = round(nfft / 4)
    elif cp_type == "Extended":
        cp_len = round(nfft / 4 + nfft / 8)
    else:
        raise ValueError(f"Wrong CP Type {cp_type!r}")
    fs = bin_spacing * nfft
    return nfft, cp_len, num_data_bins, fs


def config_from_profile(profile: dict, num_symbols: int | None = None,
                        snr_db: float | None = None) -> OFDMConfig:
    """Build an :class:`OFDMConfig` from an SDR profile dict (SDRScript.py:14-41)."""
    nfft, cp_len, num_data_bins, _fs = derive_numerology(
        profile["channel_band"], profile["bin_spacing"], profile["CP_type"])
    synch_dat = tuple(profile.get("synch_data", (1, 3)))
    nsym = num_symbols if num_symbols is not None else profile["num_symbols"][0]
    pattern = sum(synch_dat)
    nsym = int(math.ceil(nsym / pattern)) * pattern
    return OFDMConfig(
        nfft=nfft,
        cp_len=cp_len,
        num_ofdm_symb=nsym,
        synch_dat=synch_dat,
        num_data_bins=num_data_bins,
        num_synch_bins=nfft - 2,
        channel=profile["wireless_channel"],
        snr_db=snr_db if snr_db is not None else profile["SNR"],
        num_ant_txrx=profile["num_ant_txrx"],
        bin_spacing=profile["bin_spacing"],
        channel_band=profile["channel_band"],
    ).validate()


# ---------------------------------------------------------------------------
# The reference's SDR and PLS profiles
# ---------------------------------------------------------------------------

SDR_PROFILES = {
    0: {  # '4G5GSISO-TU' — TEST/GNU_RADIO_OFFLINE/TXRX_Parameters.py:1-14
        "system_scenario": "4G5GSISO-TU",
        "wireless_channel": "Fading",
        "channel_band": 0.97 * 960e3,
        "bin_spacing": 15e3,
        "channel_profile": "LTE-TU",
        "CP_type": "Normal",
        "num_ant_txrx": 1,
        "param_est": "Estimated",
        "MIMO_method": "SpMult",
        "SNR": 100,
        "ebno_db": [100] * 9,
        "num_symbols": [240] + [1000] * 8,
        "stream_size": 1,
        "synch_data": (1, 3),
    },
    1: {  # 'WIFIMIMOSM-A' — SDRScript.py:28-41
        "system_scenario": "WIFIMIMOSM-A",
        "wireless_channel": "Fading",
        "channel_band": 0.9 * 20e6,
        "bin_spacing": 312.5e3,
        "channel_profile": "Indoor A",
        "CP_type": "Extended",
        "num_ant_txrx": 2,
        "param_est": "Ideal",
        "MIMO_method": "SpMult",
        "SNR": 50,
        "ebno_db": [6, 7, 8, 9, 10, 14, 16, 20, 24],
        "num_symbols": [12] * 9,
        "stream_size": 2,
        "synch_data": (1, 3),
    },
}

PLS_PROFILES = {
    0: {  # pls_aio.py:20-26
        "bandwidth": 960e3,
        "bin_spacing": 15e3,
        "num_ant": 2,
        "bit_codebook": 1,
        "synch_data_pattern": (2, 1),
    },
}


@dataclasses.dataclass(frozen=True)
class PLSConfig:
    """Physical-layer-security (MIMO key exchange) parameters.

    Mirrors TEST/GNU_RADIO_OFFLINE/PLSParameters.py:5-103 and the embedded
    profile of pls_aio.py:20-61.  Note the PLS chain uses a *different* bin
    layout from the OFDM chains: bins sit around the FFT-vector index
    ``nfft/2`` (pls_aio.py:44-52), not around DC index 0.
    """

    bandwidth: float = 960e3
    bin_spacing: float = 15e3
    num_ant: int = 2
    bit_codebook: int = 1              # bits per codebook index
    synch_data_pattern: Tuple[int, int] = (2, 1)
    pvt_info_len: int = 8              # secret key length in bits
    num_data_bins: int = 4
    zc_primes: Tuple[int, ...] = (23, 41)   # per-synch-symbol alternation

    @property
    def nfft(self) -> int:
        return int(self.bandwidth // self.bin_spacing)

    @property
    def cp_len(self) -> int:
        return int(0.25 * self.nfft)

    @property
    def symb_len(self) -> int:
        return self.nfft + self.cp_len

    @property
    def num_synch_bins(self) -> int:
        return self.nfft - 2

    @property
    def subband_size(self) -> int:
        return self.num_ant

    @property
    def num_subbands(self) -> int:
        return self.num_data_bins // self.subband_size

    @property
    def key_len(self) -> int:
        return self.num_subbands * self.bit_codebook

    @property
    def num_data_symb(self) -> int:
        # pls_aio.py:63 (with log2(len(codebook)) == bit_codebook)
        return int(math.ceil(self.pvt_info_len /
                             (self.num_subbands * self.bit_codebook)))

    @property
    def num_synch_symb(self) -> int:
        return self.synch_data_pattern[0] * self.num_data_symb

    @property
    def total_num_symb(self) -> int:
        return self.num_synch_symb + self.num_data_symb

    @property
    def frame_len(self) -> int:
        return self.total_num_symb * self.symb_len

    def used_data_bins(self) -> Tuple[int, ...]:
        """Bins around FFT index nfft/2, DC-index excluded (pls_aio.py:44-48)."""
        dc = self.nfft // 2
        neg = list(range(dc - self.num_data_bins // 2, dc))
        pos = list(range(dc + 1, dc + self.num_data_bins // 2 + 1))
        return tuple(neg + pos)

    def used_synch_bins(self) -> Tuple[int, ...]:
        dc = self.nfft // 2
        neg = list(range(dc - self.num_synch_bins // 2, dc))
        pos = list(range(dc + 1, dc + self.num_synch_bins // 2 + 1))
        return tuple(neg + pos)

    def symbol_pattern(self) -> Tuple[int, ...]:
        base = (0,) * self.synch_data_pattern[0] + (1,) * self.synch_data_pattern[1]
        return base * self.num_data_symb


def _case(num_ofdm_symb, fs, nfft, synch_dat, num_data_bins, dsss=1):
    return {
        "num_ofdm_symb": num_ofdm_symb, "fs": fs, "nfft": nfft,
        "cp_len": nfft // 4, "num_synch_bins": nfft - 2,
        "synch_dat": tuple(synch_dat), "num_data_bins": num_data_bins,
        "snr": 100000000, "dsss": dsss,
    }


# the ten hard-coded cases of the legacy CFO-search receiver
CFO_CASES = {
    0: _case(48, 960000, 64, (1, 1), 12),
    1: _case(48, 960000, 64, (1, 1), 36),
    2: _case(48, 960000, 64, (1, 1), 48),
    3: _case(48, 960000, 64, (2, 1), 48),
    4: _case(48, 960000, 64, (3, 1), 24),
    5: _case(48, 960000, 64, (2, 1), 24),
    6: _case(24, 1920000, 128, (3, 1), 24),
    7: _case(24, 1920000, 128, (5, 1), 100),
    8: _case(12, 3840000, 256, (5, 1), 36),
    9: _case(12, 3840000, 256, (2, 1), 180),
}

# the eleven cases of the DSSS receiver, with their spreading factors
DSSS_CASES = {
    0: _case(48, 960000, 64, (1, 1), 12, dsss=1),
    1: _case(48, 960000, 64, (1, 1), 36, dsss=3),
    2: _case(48, 960000, 64, (1, 1), 48, dsss=4),
    3: _case(48, 960000, 64, (2, 1), 48, dsss=4),
    4: _case(48, 960000, 64, (3, 1), 24, dsss=2),
    5: _case(48, 960000, 64, (2, 1), 24, dsss=2),
    6: _case(24, 1920000, 128, (3, 1), 24, dsss=2),
    7: _case(24, 1920000, 128, (5, 1), 100, dsss=4),
    8: _case(12, 3840000, 256, (5, 1), 36, dsss=3),
    9: _case(12, 3840000, 256, (2, 1), 180, dsss=12),
    10: _case(12, 3840000, 256, (2, 1), 180, dsss=24),
}


def config_from_case(table: dict, case: int, **overrides) -> OFDMConfig:
    """The :class:`OFDMConfig` of one legacy case
    (``utils/params.py:config_from_case``): ZC prime 37 with the parity on
    the bins, a linear SNR, gate 0.4 and stride cp - 1."""
    c = dict(table[case])
    pattern = sum(c["synch_dat"])
    nsym = int(math.ceil(c["num_ofdm_symb"] / pattern)) * pattern
    kw = dict(
        nfft=c["nfft"], cp_len=c["cp_len"], num_ofdm_symb=nsym,
        synch_dat=c["synch_dat"], num_data_bins=c["num_data_bins"],
        num_synch_bins=c["num_synch_bins"], zc_prime=37,
        zc_parity_on="bins", snr_db=float(c["snr"]), snr_convention="linear",
        detection_gate=0.4, stride=c["cp_len"] - 1,
    )
    kw.update(overrides)
    return OFDMConfig(**kw).validate()


GOLDEN64 = OFDMConfig().validate()
LTE1024 = OFDMConfig(
    nfft=1024, cp_len=256, num_ofdm_symb=64, synch_dat=(1, 3),
    num_data_bins=960, num_synch_bins=1022, bin_spacing=15e3,
    stride=255, channel_band=15e3 * 960).validate()
LTE2048 = OFDMConfig(
    nfft=2048, cp_len=512, num_ofdm_symb=64, synch_dat=(1, 3),
    num_data_bins=1200, num_synch_bins=2046, bin_spacing=15e3,
    stride=511, channel_band=15e3 * 1200).validate()
