"""Build, bind and launch the port's hand-written CUDA kernels.

All ``csrc/*.cu`` sources compile in one ``nvcc`` call into one shared
library with a plain C interface, at first use, into ``build/torch_kernels/``
of the checkout (named by a hash of the sources and flags, so an edited
source rebuilds).  Each C entry point launches one kernel on the stream it
is given and returns ``cudaGetLastError()``; :func:`launch` raises when that
is not 0.  Nothing here runs at import: CPU-only installs import the kernel
modules and use their plain twins.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types; every one ends with the stream
SIGNATURES = {
    "ofdm_mod_fft": (_P, _P, _I, _P, _P, _I, _I, _I, _P),
    "equalize_fft": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _P),
    "channel_conv": (_P, _P, _I, _I, _I, _P, _I, _P),
    "sync_search_fft": (_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                        _P, _P),
    "sync_search_direct": (_P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                           _F, _P, _P),
    "mimo_detect_power": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P),
    "mimo_detect_scale": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P),
}
# the tracker's two routes take the same arguments (csrc/tracker.cu)
SIGNATURES["tracker_scan"] = SIGNATURES["tracker_scan_warp"] = (
    _P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
    _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def library_path() -> pathlib.Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"liblte_torch_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile (if not built yet) and load the kernels' shared library."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *map(str, sorted(CSRC.glob("*.cu")))]
        res = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode:
            raise RuntimeError(f"nvcc failed with code {res.returncode}:\n"
                               f"{res.stderr[-6000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sync_search_direct_fits.argtypes = (_I, _I, _I, _I)   # host only
    lib.sync_search_direct_fits.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = (_I,)
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    """The compiler's output (ptxas registers, shared memory, spills)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; raises on anything else (no silent moves)."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"tensors on {sorted(map(str, devices))}: expected all "
                     "on the CPU or all on one CUDA device")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on 16 bytes (the
    FFT kernels load two complex64 a thread)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(name: str, device: torch.device, *args) -> None:
    """Run C entry point ``name`` on the current stream of ``device``."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")


def require_fp32(device: torch.device) -> None:
    """float32 matmuls and convolutions in full float32 on a CUDA device
    (cuDNN runs float32 convolutions in TF32 by default)."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
