"""track_device_ms.live: device milliseconds a chunk step of the
operations launched inside the program's ``ofdm.track`` span (the ``ext``
copy, the fire limits and the tracker's step-loop kernel); None where the
trace lost device events."""

from ofdm_bench.stages import device_ms


def read(ctx: dict):
    return device_ms(ctx["trace"], "ofdm.track")
