"""tx_host_ms.link: host milliseconds a chain step in the program's
``ofdm.tx`` span (K1, K3, the signal power, AWGN), the median over the
traced steps, on the profiler's clock."""

from ofdm_bench.stages import median_stage_ms


def read(ctx: dict):
    return median_stage_ms(ctx["trace"], "ofdm.tx")
