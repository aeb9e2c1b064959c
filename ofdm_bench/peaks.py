"""The table of peaks of the card the cells run on, and the step's
readings that several per-layer metrics share."""

from __future__ import annotations

import re

import numpy as np

# NVIDIA H100 SXM data sheet, at its full 700 W power limit: HBM3 bandwidth
# and float32 outside the tensor cores (every kernel of the port computes in
# float32 with TF32 off)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 66.9e12

# the port's own CUDA kernels (``csrc/*.cu``), as the trace names them
PORT_KERNELS = re.compile(
    r"(ofdm_mod_fft|equalize_fft|channel_conv|sync_search_fft|"
    r"sync_search_direct|tracker_scan_warp|tracker_scan)_kernel")


def device_s_per_step(ctx: dict, match) -> float | None:
    """Device seconds a step in the traced events whose name ``match``
    accepts; None where the trace holds none."""
    tr = ctx["trace"]
    picked = [e - s for name, s, e in tr["device"] if match(name)]
    if not picked:
        return None
    return sum(picked) / 1e6 / tr["steps"]


def median_host_ms(ctx: dict) -> float | None:
    host = ctx.get("host_ms")
    return float(np.median(host)) if host else None
