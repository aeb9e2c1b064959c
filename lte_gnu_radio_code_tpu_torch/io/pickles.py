"""Pickle / npz I/O: the reference's persistence layer (every TX waveform,
channel estimate and soft-bit dump is a pickle), numpy only.

Copy of ``lte_gnu_radio_code_tpu/io/pickles.py`` (``load_pickle_iq``,
``save_pickle_iq``, ``pickle_check``, ``load_reference_vectors``,
``save_golden_npz``, ``load_golden_npz`` and the streaming sources
``TxPickleSource``, ``ChunkedPickleSource``, ``TimedPickleSource``), so that
the port loads nothing of the JAX package; ``tests/test_torch_io.py`` holds
the two to the same files.  Loaders read the reference's shipped vectors
(python2 pickles, latin1) and savers write protocol 2, as the reference's
blocks do (SDRScript.py:136-139, synch_and_chan_est.py:206-213,
BitRecovery.py:170-179).
"""

from __future__ import annotations

import pathlib
import pickle

import numpy as np

# the reference repository's offline test directory, relative to where the
# reference is checked out (load_reference_vectors takes another)
REF_DATA_DIR = pathlib.Path("GNU-Radio-Repositories/TEST/GNU_RADIO_OFFLINE")


def load_pickle_iq(path) -> np.ndarray:
    """Load a complex IQ (or bit) matrix from a reference-style pickle."""
    with open(path, "rb") as f:
        return np.asarray(pickle.load(f, encoding="latin1"))


def save_pickle_iq(path, data: np.ndarray) -> None:
    """protocol=2, as every reference dump does (e.g. SDRScript.py:138)."""
    with open(path, "wb") as f:
        pickle.dump(np.asarray(data), f, protocol=2)


def pickle_check(path) -> dict:
    """PickleCheck equivalent (LEGACY/gr-ofdm-rx/python/PickleCheck.py):
    returns shape/dtype/summary instead of printing."""
    data = load_pickle_iq(path)
    return {"path": str(path), "shape": data.shape, "dtype": str(data.dtype),
            "abs_max": float(np.abs(data).max()) if data.size else 0.0}


def load_reference_vectors(scenario: str = "chan_type_Fading_SNR_100",
                           directory=REF_DATA_DIR) -> dict:
    """The reference's shipped golden vectors, from its offline test
    ``directory``."""
    d = pathlib.Path(directory)
    return {
        "bits": load_pickle_iq(
            d / f"Data/tx_bit_data_{scenario}.pckl").ravel(),
        "tx_online": load_pickle_iq(
            d / f"Data/tx_data_online_{scenario}.pckl").ravel(),
        "tx_offline": load_pickle_iq(
            d / f"Data/tx_data_offline_{scenario}.pckl").ravel(),
        "golden_out": load_pickle_iq(d / "Output/_output_data.pckl").ravel(),
    }


def save_golden_npz(path, **arrays) -> None:
    """npz golden-vector format for the new framework's own regression."""
    np.savez_compressed(path, **arrays)


def load_golden_npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# Streaming sources (T1-T4)
# ---------------------------------------------------------------------------


class TxPickleSource:
    """T1: replay row 0 of a pickled IQ matrix forever
    (gr-TXOFDM/python/tx_signal_transmitter.py:13-27).

    The reference writes ``tx_data[0, :]`` into whatever buffer the GNU Radio
    scheduler hands it; the effective loopback behaviour is continuous cyclic
    replay of the row, which is what this source implements (with an explicit
    read position instead of the scheduler's buffer bookkeeping)."""

    def __init__(self, directory, file_name, case: int = 0):
        self.data = np.atleast_2d(
            load_pickle_iq(pathlib.Path(directory) / file_name))
        self.case = case
        self.pos = 0

    def __call__(self, n_samples: int) -> np.ndarray:
        row = self.data[0]
        idx = (self.pos + np.arange(n_samples)) % row.size
        self.pos = (self.pos + n_samples) % row.size
        return row[idx].astype(np.complex64)


class ChunkedPickleSource:
    """T2: stream pickle data in <=chunk-sample work calls with leftover
    carry, repeating each data set ``num_repeat`` times and rotating through
    numbered pickle files (LEGACY/gr-ofdm-tx/python/OFDMTransmitter.py:30-122).
    """

    def __init__(self, directory, file_stem, num_files: int = 1,
                 num_repeat: int = 20, max_chunk: int = 4095):
        self.dir = pathlib.Path(directory)
        self.stem = file_stem
        self.num_files = num_files
        self.num_repeat = num_repeat
        self.max_chunk = max_chunk
        self.file_idx = 0
        self.repeat_count = 0
        self.pos = 0
        self._load()

    def _load(self):
        name = f"{self.stem}{self.file_idx}.pckl"
        self.row = np.atleast_2d(load_pickle_iq(self.dir / name))[0]

    def __call__(self, n_samples: int) -> np.ndarray:
        out = np.zeros(n_samples, dtype=np.complex64)
        filled = 0
        while filled < n_samples:
            take = min(n_samples - filled, self.max_chunk,
                       self.row.size - self.pos)
            out[filled:filled + take] = self.row[self.pos:self.pos + take]
            self.pos += take
            filled += take
            if self.pos >= self.row.size:
                self.pos = 0
                self.repeat_count += 1
                if self.repeat_count >= self.num_repeat:
                    self.repeat_count = 0
                    self.file_idx = (self.file_idx + 1) % self.num_files
                    self._load()
        return out


class TimedPickleSource:
    """T3: emit row ``timer`` of the matrix, advancing the row every
    ``calls_per_row`` work calls (LEGACY/gr-ofdm-tx/python/OFDMTxWithTimer.py:32-72)."""

    def __init__(self, directory, file_name, calls_per_row: int = 30):
        self.data = np.atleast_2d(
            load_pickle_iq(pathlib.Path(directory) / file_name))
        self.calls_per_row = calls_per_row
        self.call_count = 0

    def __call__(self, n_samples: int) -> np.ndarray:
        row_idx = (self.call_count // self.calls_per_row) % self.data.shape[0]
        self.call_count += 1
        row = self.data[row_idx]
        reps = int(np.ceil(n_samples / row.size))
        return np.tile(row, reps)[:n_samples].astype(np.complex64)
