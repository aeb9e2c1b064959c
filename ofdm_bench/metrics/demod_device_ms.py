"""demod_device_ms.live: device milliseconds a chunk step of the
operations launched inside the program's ``ofdm.demod`` span
(``demod_detections``: the synch spectra at every slot, the channel
estimates, K2 over every slot, full or empty); None where the trace lost
device events."""

from ofdm_bench.stages import device_ms


def read(ctx: dict):
    return device_ms(ctx["trace"], "ofdm.demod")
