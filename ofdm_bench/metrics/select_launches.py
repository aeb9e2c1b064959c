"""select_launches.live: device operations a chunk step launched inside
the program's ``ofdm.select`` span (``refractory_table``'s rounds and the
valid mask); None where the trace lost device events."""

from ofdm_bench.stages import launches


def read(ctx: dict):
    return launches(ctx["trace"], "ofdm.select")
