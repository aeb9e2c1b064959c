"""ctypes bindings of the native host-side streaming runtime
(``native/ringbuf.cc``): a single-producer single-consumer ring buffer of
complex64 samples and a chunker that assembles fixed-size device chunks
from it.

Port of ``lte_gnu_radio_code_tpu/runtime/native.py`` (``NativeRing``,
``NativeChunker``, ``load_library``) with the same C interface and
semantics: wraparound, backpressure (a write into a full ring takes what
fits), peek, and the chunk carry in quanta of at most ``max_quantum``
samples.  The library is built from the checkout's source at first use,
with ``g++``, into ``build/native/`` (named by a hash of the source and the
flags, so an edited source rebuilds); nothing is built at import and
nothing is written into ``native/``.  Samples go in as numpy arrays or CPU
tensors and come out as CPU complex64 tensors, which the receivers of
``runtime/stream.py`` take as they are and copy to their device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

import numpy as np
import torch

_REPO = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "ringbuf.cc"
BUILD_DIR = _REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_P, _N = ctypes.c_void_p, ctypes.c_size_t
_FP = ctypes.POINTER(ctypes.c_float)
# C function -> (result type, argument types)
SIGNATURES = {
    "ring_create": (_P, (_N,)),
    "ring_destroy": (None, (_P,)),
    "ring_capacity": (_N, (_P,)),
    "ring_available": (_N, (_P,)),
    "ring_space": (_N, (_P,)),
    "ring_write": (_N, (_P, _FP, _N)),
    "ring_read": (_N, (_P, _FP, _N)),
    "ring_peek": (_N, (_P, _FP, _N)),
    "chunker_create": (_P, (_P, _N, _N)),
    "chunker_destroy": (None, (_P,)),
    "chunker_pump": (ctypes.c_int, (_P, _FP)),
    "chunker_staged": (_N, (_P,)),
}


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtorch_ofdm_ring_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (where not built yet) and load the ring library.  The build
    writes a file of its own and renames it into place, so processes that
    build at the same moment each load a whole library."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                              "-lpthread"], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"g++ failed with code {res.returncode}:\n"
                               f"{res.stderr[-4000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _samples(x) -> np.ndarray:
    """Samples (a CPU tensor or anything numpy takes) as contiguous
    complex64 numpy."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"NativeRing: samples on {x.device}; the ring "
                             "holds host samples")
        x = x.numpy()
    return np.ascontiguousarray(x, dtype=np.complex64).reshape(-1)


def _fp(arr: np.ndarray):
    return arr.ctypes.data_as(_FP)


class NativeRing:
    """complex64 SPSC ring buffer (GNU Radio's circular buffer); the
    capacity rounds up to a power of two."""

    def __init__(self, capacity: int):
        self._lib = load_library()
        self._h = self._lib.ring_create(capacity)
        if not self._h:
            raise MemoryError("ring_create failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ring_destroy(self._h)
            self._h = None

    @property
    def capacity(self) -> int:
        return self._lib.ring_capacity(self._h)

    @property
    def available(self) -> int:
        return self._lib.ring_available(self._h)

    @property
    def space(self) -> int:
        return self._lib.ring_space(self._h)

    def write(self, samples) -> int:
        """Write what fits; returns the samples written."""
        x = _samples(samples)
        return self._lib.ring_write(self._h, _fp(x.view(np.float32)), x.size)

    def _take(self, fn, n: int) -> torch.Tensor:
        out = np.empty(n, dtype=np.complex64)
        got = fn(self._h, _fp(out.view(np.float32)), n)
        return torch.from_numpy(out[:got])

    def read(self, n: int) -> torch.Tensor:
        """Up to n samples, consumed."""
        return self._take(self._lib.ring_read, n)

    def peek(self, n: int) -> torch.Tensor:
        """Up to n samples, left in the ring."""
        return self._take(self._lib.ring_peek, n)


class NativeChunker:
    """Work-quantum chunker with leftover carry (OFDMTransmitter.py:92-102
    semantics): assembles fixed-size chunks from a ring, reading it in
    quanta of at most ``max_quantum`` samples."""

    def __init__(self, ring: NativeRing, chunk: int, max_quantum: int = 4095):
        self._lib = load_library()
        self._ring = ring                 # keep the ring alive
        self.chunk = chunk
        self._h = self._lib.chunker_create(ring._h, chunk, max_quantum)
        if not self._h:
            raise MemoryError("chunker_create failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.chunker_destroy(self._h)
            self._h = None

    @property
    def staged(self) -> int:
        return self._lib.chunker_staged(self._h)

    def pump(self) -> torch.Tensor | None:
        """One whole chunk as a CPU complex64 tensor [chunk], or None while
        the ring holds too few samples (what it held stays staged)."""
        out = np.empty(self.chunk, dtype=np.complex64)
        if self._lib.chunker_pump(self._h, _fp(out.view(np.float32))):
            return torch.from_numpy(out)
        return None
