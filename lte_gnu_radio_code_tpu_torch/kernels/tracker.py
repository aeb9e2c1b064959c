"""The tracker's step loop as one persistent kernel.

No Pallas kernel stands behind this one: the JAX package runs the tracker
step (``models/tracker.py:make_tracker_step``) in one ``lax.scan``
(``models/tracker.py:217``, ``runtime/stream.py:503``) that XLA compiles
into one loop on the device.  Torch has no scan, and the step written out
in torch is some 60-90 small kernels, each step depending on the one
before, so the loop would pay that many launches a step.

:func:`track_scan` (cfg, x [B, n], x_start, fire_limit, carry, steps) ->
(carry, ys), ys = (accept [B, steps] bool, ptr, delay [B, steps] int32,
peak [B, steps] float32, h_row [B, steps, nfft] complex64): exactly the
scan's outputs, so the detection table, the channel table and the demod
after it are the same code on both paths.  On a CPU tensor it runs the
plain twin :func:`track_scan_plain`, a Python loop over the torch step.  On
a CUDA tensor it launches ``tracker_scan`` (``csrc/tracker.cu``), one block
a stream looping over every step on the device, with ``x_start``,
``fire_limit`` and the carry read from and written to device memory, so a
chunk step waits for nothing on the host.  The shape rule: nfft a power of
two in [16, 4096] (``kernels/fft.py``), m_synch >= 1, and one block's
shared memory holding the FFT rows, the m_synch * num_synch_bins synch
spectrum and the cp + 1 correlations; any other shape raises
``ValueError`` on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops.zadoff_chu import zc_for_config
from ..utils.params import OFDMConfig, used_bins
from ..utils.tables import device_table
from . import _cuda, fft

launches = 0          # kernel launches since the last reset

SMEM_LIMIT = 232448   # bytes of shared memory one H100 block may use
THREADS = 256
# the carry fields' dtypes and per-stream shapes (models/tracker.py)
CARRY = (*((torch.int32, ()),) * 6, (torch.float32, (5,)),
         (torch.float32, (5,)), (torch.float32, (2,)))


def smem_bytes(cfg: OFDMConfig) -> int:
    """Dynamic shared memory of one block: the FFT rows (``fft.cuh``'s
    staging and work buffer a row), the synch spectrum and the
    correlations, each rounded up to 16 bytes."""
    nfft = cfg.nfft
    rows = 2 * (THREADS // min(nfft // 4, THREADS)) * nfft * 8
    spec = cfg.m_synch * cfg.num_synch_bins * 8
    corr = (cfg.cp_len + 1) * 4
    return sum(-(-b // 16) * 16 for b in (rows, spec, corr))


def require(cfg: OFDMConfig) -> None:
    """Raises ValueError unless the kernel takes cfg's shape."""
    fft.require(cfg.nfft)
    if cfg.m_synch < 1:
        raise ValueError(f"m_synch {cfg.m_synch}: the tracker kernel needs "
                         "at least one synch symbol")
    if smem_bytes(cfg) > SMEM_LIMIT:
        raise ValueError(f"tracker kernel: {smem_bytes(cfg)} bytes of shared "
                         f"memory a block, more than {SMEM_LIMIT}")


@functools.lru_cache(maxsize=16)
def _tables(cfg: OFDMConfig) -> dict[str, np.ndarray]:
    """The kernel's constants: the synch bins, each FFT bin's index among
    them (-1 elsewhere), conj(ZC) and the delay matrix transposed [cp + 1,
    m_synch * num_synch_bins]."""
    from ..models import tracker as model

    bins = np.asarray(used_bins(cfg.nfft, cfg.num_synch_bins)[1], np.int32)
    slot = np.full(cfg.nfft, -1, np.int32)
    slot[bins] = np.arange(len(bins), dtype=np.int32)
    return {"bins": bins, "slot": slot,
            "zc_conj": np.conj(zc_for_config(cfg)).astype(np.complex64),
            "p_t": np.ascontiguousarray(model.delay_matrix(cfg).T)}


def _table(cfg: OFDMConfig, name: str) -> np.ndarray:
    return _tables(cfg)[name]


def track_scan_plain(cfg: OFDMConfig, x: torch.Tensor, x_start, fire_limit,
                     carry, steps: int):
    """Plain twin: ``steps`` calls of the torch step
    (``models/tracker.py:make_tracker_step``), outputs stacked on axis 1."""
    from ..models import tracker as model

    step = model.make_tracker_step(cfg, x, x_start, fire_limit)
    ys = []
    for _ in range(steps):
        carry, y = step(carry)
        ys.append(y)
    return carry, tuple(torch.stack(f, 1) for f in zip(*ys))


def track_scan(cfg: OFDMConfig, x: torch.Tensor, x_start, fire_limit,
               carry, steps: int):
    """``steps`` tracker steps over x [B, n] (module docstring): the kernel
    on a CUDA tensor, :func:`track_scan_plain` on a CPU one."""
    global launches
    from ..models import tracker as model

    if _cuda.on_cpu(x, *carry):
        return track_scan_plain(cfg, x, x_start, fire_limit, carry, steps)
    require(cfg)
    batch, n = x.shape
    dev, nfft = x.device, cfg.nfft
    _cuda.check(x, "x", torch.complex64, (batch, n))
    for (name, value), (dtype, shape) in zip(carry._asdict().items(), CARRY):
        _cuda.check(value, f"carry.{name}", dtype, (batch, *shape))
    starts = model._per_stream(x_start, batch, dev).contiguous()
    limits = model._per_stream(fire_limit, batch, dev).contiguous()
    new = type(carry)(*(torch.empty_like(c) for c in carry))
    ys = (torch.empty(batch, steps, dtype=torch.bool, device=dev),
          torch.empty(batch, steps, dtype=torch.int32, device=dev),
          torch.empty(batch, steps, dtype=torch.int32, device=dev),
          torch.empty(batch, steps, dtype=torch.float32, device=dev),
          torch.empty(batch, steps, nfft, dtype=torch.complex64, device=dev))
    tab = {k: device_table(_table, dev, cfg, k) for k in _tables(cfg)}
    tw = device_table(fft.twiddles, dev, nfft)
    c_in = (ctypes.c_void_p * 9)(*(c.data_ptr() for c in carry))
    c_out = (ctypes.c_void_p * 9)(*(c.data_ptr() for c in new))
    _cuda.launch(
        "tracker_scan", dev, x.data_ptr(), n, batch, starts.data_ptr(),
        limits.data_ptr(), ctypes.addressof(c_in), ctypes.addressof(c_out),
        steps, tab["bins"].data_ptr(), tab["slot"].data_ptr(),
        tab["zc_conj"].data_ptr(), tab["p_t"].data_ptr(), tw.data_ptr(),
        *(y.data_ptr() for y in ys), nfft, cfg.cp_len, cfg.m_synch,
        cfg.num_synch_bins, cfg.pattern_len,
        int(np.ceil(cfg.cp_len / 2)), smem_bytes(cfg),
        0.5 * cfg.m_synch * cfg.num_synch_bins, 1.0 + 1.0 / cfg.snr_linear)
    launches += 1
    return new, ys
