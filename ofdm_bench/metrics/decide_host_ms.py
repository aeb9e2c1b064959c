"""decide_host_ms.live: host milliseconds a chunk step in the program's
``ofdm.decide`` span (the new carry with its history copy, the output,
``hard_decide``), the median over the traced steps, on the profiler's
clock."""

from ofdm_bench.stages import median_stage_ms


def read(ctx: dict):
    return median_stage_ms(ctx["trace"], "ofdm.decide")
