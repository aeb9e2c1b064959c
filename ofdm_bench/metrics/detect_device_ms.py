"""detect_device_ms.link: device milliseconds a chain step of the
operations launched inside the program's ``ofdm.detect`` span (the 2x2
step's per-bin LMMSE W, its product with every data symbol, each layer's
unit-power scale); None where the trace lost device events or the program
has no such span."""

from ofdm_bench.stages import device_ms, program_spans


def read(ctx: dict):
    tr = ctx["trace"]
    if not any(n == "ofdm.detect" for n, _, _ in program_spans(tr)):
        return None
    return device_ms(tr, "ofdm.detect")
