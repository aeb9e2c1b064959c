"""The tracker's step loop as one persistent kernel, on one of two routes.

No Pallas kernel stands behind this one: the JAX package runs the tracker
step (``models/tracker.py:make_tracker_step``) in one ``lax.scan``
(``models/tracker.py:217``, ``runtime/stream.py:503``) that XLA compiles
into one loop on the device.  Torch has no scan, and the step written out
in torch is hundreds of small kernels, each step depending on the one
before, so the loop would pay that many launches a step.

:func:`track_scan` (cfg, x [B, n], x_start, fire_limit, carry, steps,
max_det) -> (carry, ys), ys = (accept [B, steps] bool, ptr, delay [B, steps]
int32, peak [B, steps] float32, chans [B, max_det, nfft] complex64): the
scan's step outputs, and its channel rows compacted as
``models/tracker.py:emit_channels`` compacts them (row k the estimate of
the k-th accepted step of this call, accepted steps past ``max_det``
dropped, zero rows past the count).  On a CPU tensor it runs the plain twin
:func:`track_scan_plain`, a Python loop over the torch step.  On a CUDA
tensor it launches the kernel :func:`route` names (``csrc/tracker.cu``),
with ``x_start``, ``fire_limit`` and the carry read from and written to
device memory, so a chunk step waits for nothing on the host:

* ``"warp"`` — ``tracker_scan_warp``, one warp a stream and ``WARPS``
  streams a block, the step's FFT and correlation (an inverse FFT) in
  registers and shuffles: nfft a power of two in [16, ``WARP_MAX_NFFT``]
  and cp < nfft, with its tables in one block's shared memory (GOLDEN64);
* ``"block"`` — ``tracker_scan``, one block of 256 threads a stream: every
  other shape with nfft a power of two up to 4096 (LTE1024, LTE2048), with
  the FFT rows and the synch spectrum in one block's shared memory.  A step
  transforms the synch windows (``csrc/fft.cuh``), forms q = sd conj(zc)
  on the synch bins, and takes the correlations at every delay as one
  unscaled inverse transform of q scattered to its bins, the argmax by a
  block reduction; the delay matrix is never read (an accepted step's
  channel row takes its column from the twiddle table).

On both routes a step that does not fire leaves the carry as it was, so
every later step of the call repeats it: the kernel writes that step's
outputs into the remaining slots and leaves its loop.  Both need m_synch
>= 1; any other shape raises ``ValueError`` on a CUDA tensor.  Neither
route falls back to the other or to the twin.
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

launches = 0                                # kernel launches since reset
route_launches = {"warp": 0, "block": 0}    # the same, by route

SMEM_LIMIT = 232448   # bytes of shared memory one H100 block may use
THREADS = 256         # threads of a block on the block route
WARP_MAX_NFFT = 128   # the warp route's largest nfft: 4 points a lane
WARPS = 4             # streams a block on the warp route (tracker.cu:kStreams)
ENTRY = {"warp": "tracker_scan_warp", "block": "tracker_scan"}
# the carry fields' dtypes and per-stream shapes (models/tracker.py)
CARRY = (*((torch.int32, ()),) * 6, (torch.int32, (5,)),
         (torch.int32, (5,)), (torch.float32, (2,)))


def smem_bytes(cfg: OFDMConfig, kind: str) -> int:
    """Dynamic shared memory of one block of route ``kind``.  Warp: the
    delay matrix and conj(ZC) in the warp's register order, (cp + 1 +
    m_synch) rows of max(nfft, 32) complex64.  Block: the FFT rows
    (``fft.cuh``'s staging and work buffer a row; the first row's also
    hold q and its inverse transform) and the synch spectrum, each rounded
    up to 16 bytes."""
    nfft = cfg.nfft
    if kind == "warp":
        return (cfg.cp_len + 1 + cfg.m_synch) * max(nfft, 32) * 8
    rows = 2 * (THREADS // min(nfft // 4, THREADS)) * nfft * 8
    spec = cfg.m_synch * cfg.num_synch_bins * 8
    return sum(-(-b // 16) * 16 for b in (rows, spec))


def route(cfg: OFDMConfig) -> str:
    """``"warp"`` or ``"block"``: the kernel a CUDA tensor of cfg's shape
    goes to (module docstring); ValueError for a shape neither takes."""
    fft.require(cfg.nfft)
    if cfg.m_synch < 1:
        raise ValueError(f"m_synch {cfg.m_synch}: the tracker kernels need "
                         "at least one synch symbol")
    kind = ("warp" if cfg.nfft <= WARP_MAX_NFFT and cfg.cp_len < cfg.nfft
            else "block")
    if smem_bytes(cfg, kind) > SMEM_LIMIT:
        raise ValueError(f"tracker kernel ({kind}): {smem_bytes(cfg, kind)} "
                         f"bytes of shared memory a block, more than "
                         f"{SMEM_LIMIT}")
    return kind


@functools.lru_cache(maxsize=16)
def _tables(cfg: OFDMConfig) -> dict[str, np.ndarray]:
    """Both routes' constants: the synch bins, each FFT bin's index among
    them (-1 elsewhere) and conj(ZC)."""
    bins = np.asarray(used_bins(cfg.nfft, cfg.num_synch_bins)[1], np.int32)
    slot = np.full(cfg.nfft, -1, np.int32)
    slot[bins] = np.arange(len(bins), dtype=np.int32)
    return {"bins": bins, "slot": slot,
            "zc_conj": np.conj(zc_for_config(cfg)).astype(np.complex64)}


def _table(cfg: OFDMConfig, name: str) -> np.ndarray:
    return _tables(cfg)[name]


def _delay_table(cfg: OFDMConfig) -> np.ndarray:
    """The delay matrix transposed [cp + 1, m_synch * num_synch_bins]: the
    warp route's table (the block route takes the same values from the
    twiddles, and is handed a null pointer in its place)."""
    from ..models import tracker as model

    return np.ascontiguousarray(model.delay_matrix(cfg).T)


def track_scan_plain(cfg: OFDMConfig, x: torch.Tensor, x_start, fire_limit,
                     carry, steps: int, max_det: int):
    """Plain twin: ``steps`` calls of the torch step
    (``models/tracker.py:make_tracker_step``), the step outputs stacked on
    axis 1 and the channel rows compacted by ``emit_channels``."""
    from ..models import tracker as model

    step = model.make_tracker_step(cfg, x, x_start, fire_limit)
    ys = []
    for _ in range(steps):
        carry, y = step(carry)
        ys.append(y)
    acc, ptr, delay, peak, rows = (torch.stack(f, 1) for f in zip(*ys))
    return carry, (acc, ptr, delay, peak,
                   model.emit_channels(acc, rows, max_det))


def _launch(kind: str, cfg: OFDMConfig, x: torch.Tensor, x_start,
            fire_limit, carry, steps: int, max_det: int):
    """Launch the kernel of route ``kind`` (the wrapper's CUDA branch;
    tests and ``chip_smoke.py`` call it to hold either kernel at a shape
    the rule gives to the other)."""
    global launches
    from ..models import tracker as model

    if kind not in ENTRY:
        raise ValueError(f"unknown tracker route {kind!r}")
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
          torch.empty(batch, max_det, nfft, dtype=torch.complex64,
                      device=dev))
    tab = {k: device_table(_table, dev, cfg, k) for k in _tables(cfg)}
    tw = device_table(fft.twiddles, dev, nfft)
    p_t = (device_table(_delay_table, dev, cfg).data_ptr() if kind == "warp"
           else 0)
    c_in = (ctypes.c_void_p * 9)(*(c.data_ptr() for c in carry))
    c_out = (ctypes.c_void_p * 9)(*(c.data_ptr() for c in new))
    _cuda.launch(
        ENTRY[kind], dev, x.data_ptr(), n, batch, starts.data_ptr(),
        limits.data_ptr(), ctypes.addressof(c_in), ctypes.addressof(c_out),
        steps, max_det, tab["bins"].data_ptr(), tab["slot"].data_ptr(),
        tab["zc_conj"].data_ptr(), p_t, tw.data_ptr(),
        *(y.data_ptr() for y in ys), nfft, cfg.cp_len, cfg.m_synch,
        cfg.num_synch_bins, cfg.pattern_len, int(np.ceil(cfg.cp_len / 2)),
        smem_bytes(cfg, kind),
        0.5 * cfg.m_synch * cfg.num_synch_bins, 1.0 + 1.0 / cfg.snr_linear)
    launches += 1
    route_launches[kind] += 1
    return new, ys


def track_scan(cfg: OFDMConfig, x: torch.Tensor, x_start, fire_limit,
               carry, steps: int, max_det: int):
    """``steps`` tracker steps over x [B, n] (module docstring): the kernel
    :func:`route` names on a CUDA tensor, :func:`track_scan_plain` on a
    CPU one."""
    if _cuda.on_cpu(x, *carry):
        return track_scan_plain(cfg, x, x_start, fire_limit, carry, steps,
                                max_det)
    return _launch(route(cfg), cfg, x, x_start, fire_limit, carry, steps,
                   max_det)
