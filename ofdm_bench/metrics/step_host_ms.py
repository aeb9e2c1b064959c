"""step_host_ms.live: the host's milliseconds to enqueue one chunk step
(``BatchReacqStreamingRx.push``) on an idle device, the median over the
steps timed."""

from ofdm_bench.peaks import median_host_ms


def read(ctx: dict):
    return median_host_ms(ctx)
