"""select_host_ms.live: host milliseconds a chunk step in the program's
``ofdm.select`` span (``refractory_table`` and the valid mask), the median
over the traced steps, on the profiler's clock."""

from ofdm_bench.stages import median_stage_ms


def read(ctx: dict):
    return median_stage_ms(ctx["trace"], "ofdm.select")
