"""tracker_step_us.live: device microseconds of the tracker scan's
kernels (``tracker_scan*``) a chunk step over the steps its slowest
stream computed: the time of one dependent step, which bounds a stream's
chunk step whatever the batch.  The program keeps each traced step's
computed steps a stream (``ofdm.fired``); the reading is the kernels' mean
device time a step over the mean of each step's largest stream count.  A
program without the counter reads None."""

from ofdm_bench.peaks import device_s_per_step
from ofdm_bench.metrics.tracker_roofline import KERNELS


def slowest_per_step() -> float | None:
    from lte_gnu_radio_code_tpu_torch.utils import profiling
    kept = getattr(profiling, "kept", None)
    vals = kept("ofdm.fired") if kept else []
    if not vals:
        return None
    return sum(int(v.max()) for v in vals) / len(vals)


def read(ctx: dict):
    slowest = slowest_per_step()
    s = device_s_per_step(ctx, lambda name: KERNELS.search(name))
    if not slowest or s is None:
        return None
    return s * 1e6 / slowest
