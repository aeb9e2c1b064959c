"""track_host_ms.live: host milliseconds a chunk step in the program's
``ofdm.track`` span (the ``ext`` assembly and the tracker scan,
``kernels/tracker.py:track_scan``), the median over the traced steps, on
the profiler's clock."""

from ofdm_bench.stages import median_stage_ms


def read(ctx: dict):
    return median_stage_ms(ctx["trace"], "ofdm.track")
