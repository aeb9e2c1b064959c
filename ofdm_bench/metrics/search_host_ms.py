"""search_host_ms.<link|live>: host milliseconds a step in the program's
``ofdm.search`` span (link: the K4 call; live: the ``ext`` assembly, K4
and the per-trial max, the gate), the median over the traced steps, on
the profiler's clock."""

from ofdm_bench.stages import median_stage_ms


def read(ctx: dict):
    return median_stage_ms(ctx["trace"], "ofdm.search")
