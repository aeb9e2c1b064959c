"""demod_host_ms.<link|live>: host milliseconds a step in the program's
``ofdm.demod`` span (link: the spectrum at the lock, the channel estimate,
windows, coefficients and K2, or the pilot path; live:
``demod_detections``), the median over the traced steps, on the
profiler's clock."""

from ofdm_bench.stages import median_stage_ms


def read(ctx: dict):
    return median_stage_ms(ctx["trace"], "ofdm.demod")
