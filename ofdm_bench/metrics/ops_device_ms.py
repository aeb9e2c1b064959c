"""ops_device_ms.<link|live>: device milliseconds a step in operations
that are not the port's own CUDA kernels (torch operators' kernels, cuFFT,
cuBLAS, copies and fills), from the trace."""

from ofdm_bench.peaks import PORT_KERNELS, device_s_per_step


def read(ctx: dict):
    s = device_s_per_step(ctx, lambda name: not PORT_KERNELS.search(name))
    return None if s is None else s * 1e3
