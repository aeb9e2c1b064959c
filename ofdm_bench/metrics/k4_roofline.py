"""k4_roofline.<link|live>: K4's least time a step over the device time of
the kernels that compute it, in percent.

K4 is the sync search's function, |ZC correlation| of every trial and
delay with the synch-bin power normalisation, whatever kernel computes it.
Its least time is the larger of its bytes at the HBM rate (the samples
read once, the [B, trials, cp + 1] float32 output written once) and the
float32 operations of its cheapest known form, the FFT form: per trial
m_synch forward transforms and one inverse at 5 N log2 N, and per window
and bin a complex multiply-add and the power (12).  The kernels timed are
the ``sync_search_*`` ones of ``csrc/sync_search.cu``; a change that
computes the function in kernels of other names leaves this metric
silent, never above 100 %."""

import math
import re

from ofdm_bench.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S, device_s_per_step

KERNELS = re.compile(r"sync_search_(fft|direct)_kernel")


def k4_bytes(batch, n, n_trials, cp, **_):
    return batch * n * 8 + batch * n_trials * (cp + 1) * 4


def k4_ops(batch, n_trials, nfft, m_synch, **_):
    per_trial = (5 * (m_synch + 1) * nfft * int(math.log2(nfft)) +
                 12 * m_synch * nfft)
    return batch * n_trials * per_trial


def k4_least_s(shape: dict) -> float:
    return max(k4_bytes(**shape) / HBM_BYTES_PER_S,
               k4_ops(**shape) / FP32_OPS_PER_S)


def read(ctx: dict):
    s = device_s_per_step(ctx, lambda name: KERNELS.search(name))
    if s is None:
        return None
    return 100.0 * k4_least_s(ctx["k4"]) / s
