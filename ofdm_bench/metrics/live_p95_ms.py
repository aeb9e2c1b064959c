"""live_p95_ms: the 95th percentile over every chunk step of the window of
(its outputs complete on the device) - (its due time), as ``live_p50_ms``
takes the median of the same latencies."""


def read(ctx: dict):
    return ctx.get("window", {}).get("live_p95_ms")
