"""tracker_roofline.live: the tracker scan's least time a chunk step over
the device time of the kernels that run it, in percent.

The scan's work is what the step's data needs, whichever route ran: a
step that does not fire leaves the carry as it was, so a stream computes
its fired steps and at most one more, which the program counts while the
profiler records (``ofdm.fired``, the mean a traced step over every
stream here).  Each computed step's cheapest form is m_synch forward
transforms and one inverse of nfft points at 5 N log2 N, the product
q = X conj(zc), the power and the normalisation over the synch bins (24 a
bin) and the cp + 1 magnitudes (3 each), in float32; its bytes are the
samples its windows read, each once, the carry read and written, the step
outputs (accept, pointer, delay, peak a slot) and the channel table
written.  The least time is the larger of bytes / 3.35 TB/s and
operations / 66.9 TFLOP/s (``peaks.py``).  The counts are those of the
program's ``chip_smoke.py:tracker_work``.  The kernels timed are
``csrc/tracker.cu``'s ``tracker_scan*``; a program without the counter
reads None."""

import math
import re

from ofdm_bench.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S, device_s_per_step
from ofdm_bench.stages import program_counters

KERNELS = re.compile(r"tracker_scan(_warp)?_kernel")
CARRY_BYTES = (6 + 5 + 5) * 4 + 2 * 4      # nine leaves a stream
SLOT_BYTES = 1 + 4 + 4 + 4                 # accept, ptr, delay, peak


def computed_per_step(counts: dict | None) -> float | None:
    """The mean over the traced steps of the steps the scan computed,
    summed over the streams."""
    total, records = (counts or {}).get("ofdm.fired", (0, 0))
    return total / records if records else None


def tracker_bytes(computed, batch, n, nfft, m_synch, steps, max_det, **_):
    read = min(computed * m_synch * nfft, batch * n) * 8
    return (read + 2 * batch * CARRY_BYTES + batch * steps * SLOT_BYTES +
            batch * max_det * nfft * 8)


def tracker_ops(computed, nfft, cp, m_synch, num_synch_bins, **_):
    per_step = ((m_synch + 1) * 5 * nfft * int(math.log2(nfft)) +
                24 * m_synch * num_synch_bins + 3 * (cp + 1))
    return computed * per_step


def tracker_least_s(computed: float, shape: dict) -> float:
    return max(tracker_bytes(computed, **shape) / HBM_BYTES_PER_S,
               tracker_ops(computed, **shape) / FP32_OPS_PER_S)


def read(ctx: dict):
    computed = computed_per_step(program_counters())
    s = device_s_per_step(ctx, lambda name: KERNELS.search(name))
    if computed is None or s is None:
        return None
    return 100.0 * tracker_least_s(computed, ctx["k4"]) / s
