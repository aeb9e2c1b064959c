"""detect_roofline.link: the 2x2 LMMSE's least time a chain step over the
device time of the operations launched inside the program's
``ofdm.detect`` span, in percent.

The function is the per-bin detection of both layers of every detected
frame, whatever computes it: W_b = (H_b^H H_b + I / snr)^-1 H_b^H on each
data bin, x = W_b y on each data symbol, each layer scaled to unit mean
power.  Its bytes: each frame's data bins read once on both RX antennas,
H on the data bins read once, both layers written once, complex64.  Its
float32 operations in the cheapest form: a bin's W 80 (the Hermitian
Gram matrix 28, the load 2, the inverse 10, the product with H^H 40) and a
symbol-bin's 40 (W y 28, both layers' power 8, the scale 4).  The least
time is the larger of bytes / 3.35 TB/s and operations / 66.9 TFLOP/s
(``peaks.py``).  The frames a step are the program's counter
``ofdm.detect_frames`` (kept while the profiler records); the shape is the
entry's.  A program without the counter or the span reads None."""

from ofdm_bench.metrics.detect_device_ms import read as detect_ms
from ofdm_bench.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S
from ofdm_bench.stages import program_counters

C64 = 8                 # bytes of a complex64
OPS_PER_BIN = 28 + 2 + 10 + 40
OPS_PER_SYMBOL_BIN = 28 + 8 + 4


def frames_per_step(counts: dict | None) -> float | None:
    total, records = (counts or {}).get("ofdm.detect_frames", (0, 0))
    return total / records if records else None


def detect_bytes(frames, num_data_symb, num_data_bins, **_):
    per_frame = (2 * num_data_symb * num_data_bins * C64 +
                 4 * num_data_bins * C64 +
                 2 * num_data_symb * num_data_bins * C64)
    return frames * per_frame


def detect_ops(frames, num_data_symb, num_data_bins, **_):
    return frames * num_data_bins * (OPS_PER_BIN +
                                     OPS_PER_SYMBOL_BIN * num_data_symb)


def detect_least_s(frames: float, shape: dict) -> float:
    return max(detect_bytes(frames, **shape) / HBM_BYTES_PER_S,
               detect_ops(frames, **shape) / FP32_OPS_PER_S)


def read(ctx: dict):
    frames = frames_per_step(program_counters())
    ms = detect_ms(ctx)
    if not frames or not ms:
        return None
    return 100.0 * detect_least_s(frames, ctx["k4"]) / (ms / 1e3)
