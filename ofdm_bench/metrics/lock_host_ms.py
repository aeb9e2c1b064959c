"""lock_host_ms.link: host milliseconds a chain step in the program's
``ofdm.lock`` span (``sync.first_lock``), the median over the traced
steps, on the profiler's clock."""

from ofdm_bench.stages import median_stage_ms


def read(ctx: dict):
    return median_stage_ms(ctx["trace"], "ofdm.lock")
