"""lock_device_ms.link: device milliseconds a chain step of the operations
launched inside the program's ``ofdm.lock`` span (``sync.first_lock``'s
reductions and gathers); None where the trace lost device events."""

from ofdm_bench.stages import device_ms


def read(ctx: dict):
    return device_ms(ctx["trace"], "ofdm.lock")
