"""chain_host_ms.link: the host's milliseconds to enqueue one
``chain_batch`` step on an idle device, the median over the steps timed."""

from ofdm_bench.peaks import median_host_ms


def read(ctx: dict):
    return median_host_ms(ctx)
