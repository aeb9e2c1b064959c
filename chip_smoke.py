#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the CUDA
kernels, holds each against its plain PyTorch twin at the main path's
shapes (with the bytes it moves, the operations it does, the least time
the card could take for them and one PyTorch library call's time), then
drives the loopback chain (``models.chain.chain_batch``) at GOLDEN64
batch 128, LTE1024 batch 32 and LTE2048 batch 32 and checks every frame
locks with BER 0, that every kernel launched, and that the kernel chain's
bits equal the plain chain's on the same noise.  K4, the sync search, has
two kernels chosen by a rule on the shape: its route is checked in each
shape, it is also held to the FFT-form plain version and to a float64
evaluation, and each route is run at both strides.  The loopback entry
point (``cli.ofdm_chain``) runs once with no ``--device``.

Then the serving path (``runtime.stream.BatchReacqStreamingRx``, the
continuous multi-detection receiver) takes 16 streams made on the card
(frames of different bits through the port's TX, Fading channel and AWGN
at 100 dB, concatenated and cut into chunks) at LTE1024 (16 chunks of
65280 a ``push_many``), GOLDEN64 (4 of 65520) and LTE2048 (8 of 130816):
every whole pattern block detected once with the sent bits, kernel path
== plain path, streaming == whole buffer, ``push_many`` == pushes, batch
== single stream, resume from a checkpoint == uninterrupted, one K4 and
one K2 launch a chunk step, no host synchronisation inside a step, the
receiver's CUDA graph path (a full chunk replays the step captured at the
first) against the eager ``reacq_step`` chain, the single-lock ``StreamingRx``,
and K4 and K2 against their plain versions at the serving shapes.

Then the other receiver generations.  ``qam_run``: the chain again at the
shipped QAM64 config (GOLDEN64, Fading, batch 128; also at its own 24 dB,
kernel and plain chains within 1e-4 of the bits), at the shipped QAM16 +
LTE-like pilot config (spacing 4, Ideal, batch 128) and at LTE1024 + QAM64 +
pilots every 6 bins (Fading, batch 32), each with its four kernels held to
their plain versions at its shapes (K2 with the rotation alone where the
pilots estimate the channel), one launch of each a step.  The serving path
once more on QAM16 streams.  ``legacy_run``: ``LegacyStreamingRx`` on a
stream of over a million samples made on the card, CFO case 7 (three
candidates; +1500 Hz injected, and none) and DSSS case 9, chunk = 2048
strides: detections against what was sent, chunked == whole buffer, K2
path == plain path, one K2 launch and no other kernel a step, no host
synchronisation.  ``split_check``: the split RX == ``rx_frame``.  The CLI
check also runs ``cli.ber_sweep`` and a pilot config, and the file CLIs
(``file_check``: ``tx_file --generate``, ``ofdm_chain --tx-pickle`` and
``--stream``, ``rx_file --case 7 --stream``).

Last, the tracker, whose step loop is a fifth kernel with two routes
(``csrc/tracker.cu``: one warp a stream at nfft <= 128, one block a stream
above).  ``tracker_run``: ``make_tracker`` on 16 GOLDEN64 buffers made on
the card (the warp route), 60 detections each with BER 0, one tracker and
one K2 launch a call, kernel path == plain path, both routes' scans == the
plain twin in every carry field; the call, both routes' kernels and the
plain loop eager, timed, and one call profiled; then the same at the batch
that fills the card (8 streams on each SM), warp route == block route
there.
``tracker_block_run``: the block route on its own path, LTE1024 and
LTE2048 buffers; ``tracker_fill_run``: LTE1024 at the batch that fills the
card (8 streams of 256 threads on each SM), its first 4 streams == a call
on those 4 alone; each also holds K2 to its plain version on what the call
hands it.  ``tracker_stream_run``: ``TrackerStreamingRx`` on a GOLDEN64
16-frame stream with a gap, chunks of 2400 strides (the warp route), and
an 8-frame LTE1024 stream, chunks of 1024 strides (the block route):
chunked == whole buffer, ``push_many`` == pushes, one launch a chunk step
on the rule's route, no host synchronisation in a chunk step, and the
tracker kernel and K2 held to their plain versions on a chunk step's
inputs.  ``tracker_cell_run``: ``BatchTrackerStreamingRx`` at the
l1k-track cell's shape (16 10 MHz LTE streams, chunks of 131,072): every
detection on the block grid with the sent bits, and the scan of a tracking
chunk step == the plain twin, timed from a cold and a warm L2.

Then the 2x2 paths.  ``mimo_run``: ``make_mimo_chain`` (SpMult) and
``make_stcode_chain`` (Alamouti) at tests/test_mimo.py's configuration,
128 frames a step, at the reference's 2x2 profile WIFIMIMOSM-A with
synch_dat (2, 2), 1024 frames, and at the benchmark's lte2048_2x2 (20 MHz
LTE, synch_dat (2, 6)), 8 frames, over the 2x2 Fading channel at 100 dB:
every frame locked with BER 0, one K4 launch a step (ZC slice 0; the direct
route at nfft 64, the FFT route at 2048), the detection's two launches a
SpMult step and no other kernel, kernel path == plain path, no host
synchronisation in a step; WIFIMIMOSM-A also at its own 50 dB and
lte2048_2x2 at 12 dB, kernel and plain paths within 1e-4 of the bits; K4
against its plain versions at the step's search shape.  After the SpMult
steps of lte2048_2x2 and WIFIMIMOSM-A, ``detect_run``: the detection's
kernel pair (``kernels/mimo_detect.py``) at the l2k-2x2-link step's shape
(lte2048_2x2 at 12 dB, 64 frames) and at WIFIMIMOSM-A b1024 (50 dB), on
what the chain hands it, against its twin and timed beside it and the
broadcast ``torch.matmul`` that computed W y before; its launch count is
the one ``mimo_run`` counted a step.  ``pls_run``: ``key_exchange_synced`` on 256 exchanges over a
flat and a Fading 2x2 channel delayed by 40 samples, noise-free (every key
recovered) and at 40 dB, both locks as expected in every exchange.
``oracle_run``: the card's full-width paths against the port's numpy
oracles (``reference_cpu/``: NumPy loops that share only the configuration
with the port's paths), on the same buffers made on the card and copied to
the host: the first 8 frames of the GOLDEN64 b128 and LTE1024 b32 chains
(``golden.py``; the RX outputs those of a replayed ``chain_batch`` step) and of GOLDEN64 QAM64 b128 at its own 24 dB (``qam.py``),
64 pattern blocks of the CFO case 7 (+1500 Hz) and DSSS case 9 streams
(``legacy.py``), 4 streams of each tracker cell (``tracker.py``) and 16 PLS
exchanges (``pls.py``), each with the JAX package's test tolerances and its
host seconds.
``native_check``: an LTE1024 stream made on the card, written from the host
into the native ring in pieces of at most 4095 samples and pumped in
chunks of 65280 into ``ReacqStreamingRx`` on the card: the same outputs as
the chunks pushed from the card and as the plain receiver on the ring's
chunks, every block detected with its bits; K4 and K2 against their plain
versions at this single stream's shapes.

Then the sharded runtime (``parallel/``: t shards stacked on the card,
one K4 and one K2 launch a call or chunk step whatever t is).
``sharded_rx_run``: one frame made on the card, GOLDEN64 at t = 2, 4 and 8,
LTE1024 and LTE2048 at t = 4: found, lock, delay and bits equal to the
plain path's and to the single-device ``rx_frame``'s, phasors within 2e-4,
the peak within K4's tolerance.  ``sharded_chain_run``: the dp x t chain
at GOLDEN64 batch 128 (t = 2) and LTE1024 batch 32 (t = 4): on one noise
tensor BER, found and lock equal to ``chain_batch``'s, BER 0, one launch
of each of K1-K4 a step.
``sharded_stream_run``: ``ShardedReacqStreamingRx`` on an LTE1024 stream
(16 chunks of 65280, t = 4) and a GOLDEN64 one (4 of 65520, t = 8): equal
to ``ReacqStreamingRx`` on the same chunks and to ``rx_detections`` on the
whole buffer, every block detected once with the sent bits, ``push_many``
== pushes, no host synchronisation in a step.  ``sharded_legacy_run``:
``ShardedLegacyStreamingRx`` at CFO case 7 (+1500 Hz, t = 4) and DSSS case
9 (t = 2) against ``LegacyStreamingRx`` on the same chunks.  Each prints
ms a step, busy, idle share and launches beside its unsharded twin's from
the same run, and holds K4 and K2 to their plain versions on what the
sharded path handed them.  ``multihost_run``: two processes of this script
(``--multihost-worker``) on the one card over gloo, dp = 2 x t = 2, 16
LTE1024 frames each: every frame locked with BER 0, the gathered results
== one process's chain on the same noise; beside them a process group of
one on the default backend, NCCL (``--nccl-worker``).  ``cards_run``: "t"
across processes (``--cards-worker``), 2 x 2 shards, on this card over
gloo: the LTE1024 and GOLDEN64 sharded RX, the LTE1024 reacq stream and
the CFO case 7 legacy stream, then dp 2 x "t" 4 in 4 processes on the
LTE1024 b32 chain; over NCCL, one process a card, where 2 cards or more
are visible (else it says so).  Every worker exits 0; every rank == this
process's stacked run of the same mesh shape on the same buffers, one K4
and one K2 launch a call or step; ms beside the stacked twin's and the
bytes a rank hands the group; rank 0's K4 and K2 rows at its shapes.

K4's rows, wherever the script holds K4 (``sync_checks``), are its peaks
form, the form every main path takes (each trial's peak and delay,
reduced inside the kernel): equal to the same kernel's surface reduced by
max(-1), values and delays bit for bit, on both routes; timed beside the
surface form alone and with that reduction, against its bound.
``k4_link_run``: that check at GOLDEN64 b512, the g64-link cell's shape.
``chain_graph_run``: at the link cells' shapes (GOLDEN64 b512, LTE2048
b32), ``chain_batch`` given ``noise=`` (one replay of the CUDA graph
captured at each configuration's first step) against its eager body on
two SNR points by two input sets made on the card, stepped in turn: every
output field equal bit for bit, the same launch counts, no host
synchronisation in a replay; the ms a step and the host's ms to enqueue
one of each.
``chain_run``, ``serving_run`` and ``mimo_run`` also gate every K4 launch
of their main path to the peaks form.

Run from the repository root:  python3 chip_smoke.py
(``--tracker-block``: the block route's LTE1024 and LTE2048 paths and the
l1k-track cell's receiver alone; a copy of the script in a parent commit's
tree times that tree's kernel.
``--cards [gloo|nccl]``: ``cards_run`` alone.)
Exits non-zero, printing no result, without a CUDA device or outside the
repository.  The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import pathlib
import platform
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
SEED = 0
CHAIN_REPS = 20
CHAIN_ROUNDS = 3              # the chain is timed this often; median kept
TIMING_REPS = 20
CELLS = (("GOLDEN64", 128), ("LTE1024", 32), ("LTE2048", 32))
# K4 alone at the g64-link cell's shape: config and frames
K4_LINK = ("GOLDEN64", 512)
LINK_CELLS = (("GOLDEN64", 512), ("LTE2048", 32))   # the link cells' shapes
LINK_SNRS = (6.0, 24.0)       # two of the link cells' SNR points
# serving shapes: config, streams, chunk length (256 strides at the LTE
# sizes), chunks a push_many
SERVING = (("LTE1024", 16, 65280, 16), ("GOLDEN64", 16, 65520, 4),
           ("LTE2048", 16, 130816, 8))
# the same on QAM16 streams: the demap's other branch behind K2.  The last
# number is the share of hard bits that may differ from the sent bits: in a
# continuous stream the dense search's first gate crossing lies 15 samples
# before each block (delay 16), which leaves one sample of the cyclic
# prefix to a channel of five taps; the leak from the symbol before is
# nothing to QPSK and flips about 1.5 QAM16 bits in a million (8 of 5.2 M
# on the CPU, in either package's receiver).
SERVING_QAM = ("GOLDEN64", dict(modulation="QAM16"), 16, 65520, 4, 1e-5)
# QAM and pilot chains: config file or (base config, changes), batch, and
# the mean BER allowed at 100 dB.  QAM64 on GOLDEN64's 60 bins over Fading
# has a floor without any noise, in both packages: the RX scales each window
# to unit power on the used bins, the TX each symbol to unit energy, and
# through a frequency-selective channel the two differ by a factor that
# depends on the symbol's data; about one data symbol in 15,000 has its
# outer points pushed over a decision threshold (3 of 256 frames, each with
# one symbol of 37-49 wrong bits, on the CPU at this seed).
QAM_CELLS = (
    ("GOLDEN64 QAM64", "configs/qam64_sweep.json", None, 128, 1e-4),
    ("GOLDEN64 QAM16 pilots", "configs/tx16qam.json", None, 128, 0.0),
    ("LTE1024 QAM64 pilots", "LTE1024",
     dict(modulation="QAM64", pilot_grid="lte", pilot_spacing=6), 32, 0.0),
)
# legacy receivers: case table, case, candidates, injected CFO in Hz
LEGACY = (("CFO_CASES", 7, (0.0, -1500.0, 1500.0), 1500.0),
          ("CFO_CASES", 7, (0.0, -1500.0, 1500.0), 0.0),
          ("DSSS_CASES", 9, (0.0,), 0.0))
LEGACY_SAMPLES = 1 << 20      # at least this many samples a legacy stream
LEGACY_CHUNK_STRIDES = 2048
LEGACY_NOISE_DB = 60.0        # noise under the legacy streams' signal
SERVING_ROUNDS = 3            # a push_many is timed this often; median kept
PROFILE_TRIES = 4             # a trace that lost device events is retaken
# the host's calls that each put one kernel or copy on the device
LAUNCH_CALL = re.compile(r"cu(da)?(Launch|Memcpy|Memset)")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 66.9e12      # the same: float32 outside the tensor cores
L2_EVICT_BYTES = 256 << 20    # read before each timed launch: > 5x the L2
SLEEP_CLOCK_HZ = 2.0e9        # above the H100's 1.98 GHz boost clock, so a
                              # sleep of t * this many cycles lasts >= t
# tracker: config, streams (the JAX bench's tracker batch,
# bench_generations.py:173-200), SNR of its buffers (:175)
TRACKER = ("GOLDEN64", 16, 80.0)
# the block route's main paths (nfft above the warp route's limit)
TRACKER_LTE = (("LTE1024", 4, 80.0), ("LTE2048", 4, 80.0))
TRACKER_FILL_PER_SM = 8       # streams on each SM in the card-filling batch
                              # (GOLDEN64 on the warp route; LTE1024 on the
                              # block route, 256 threads a stream: 2048 an SM)
# one tracker stream each: config, frames, chunk in strides, and the frame
# whose start + 37 samples gets TRACKER_GAP zero samples (None: no gap)
TRACKER_STREAMS = (("GOLDEN64", 16, 2400, 2),
                   ("LTE1024", 8, 1024, None))
# the l1k-track cell's receiver: 10 MHz LTE (600 data bins) at 20 dB, the
# streams, the chunk and the chunk steps run before the one timed
TRACKER_CELL = (dict(num_data_bins=600, channel_band=9e6, snr_db=20.0), 16,
                131072, 4)
TRACKER_GAP = 3               # zero samples inserted into the stream
CHASE_BYTES = 4 << 20         # pointer-chase ring: in the L2, beyond the L1
CHASE_STEPS = 1 << 14
# 2x2 MIMO cells: name, configuration, frames a step.  The test config is
# tests/test_mimo.py:_cfg() (GOLDEN64's numerology, synch_dat (2, 2), 48
# symbols); WIFIMIMOSM-A is the reference's 2x2 profile (SDRScript.py:28-41)
# with synch_dat (2, 2), which the 2x2 pilots need; its own 50 dB runs too.
# lte2048_2x2 is the benchmark's 20 MHz LTE 2x2 configuration (synch_dat
# (2, 6), 64 symbols; K4's FFT route), also at 12 dB.
MIMO_CELLS = (("MIMO test cfg", None, 128), ("WIFIMIMOSM-A", 1, 1024),
              ("LTE-20 2x2", "lte2048_2x2", 8))
# the SpMult detection's kernel rows, by MIMO_CELLS' configuration: the
# l2k-2x2-link step's 64 frames and WIFIMIMOSM-A at b1024, each at its own SNR
DETECT_BATCH = {"lte2048_2x2": 64, 1: 1024}
# PLS: exchanges a batch (bench_generations.py:67), the delay past the cp
# and the search's span (tests/test_pls.py), the AWGN of that test
PLS_BATCH = 256
PLS_DELAY = 40
PLS_MAX_DELAY = 64
PLS_SNR_DB = 40.0
PLS_ROUNDS = 3
# the reference's 2x2 Fading taps, unnormalised ([rx][tx]; the PLS channel
# normalises each pair), MultiAntennaSystem.py:69-74
MIMO2_FADING = (
    ((0.3977, 0.7954 - 0.3977j, -0.1988, 0.0994, -0.0398), (0.8423j, 0.5391)),
    ((0.1631, -0.0815 + 0.9784j, 0.0978),
     (0.0572j, 0.3659j, 0.5717 - 0.5717j, 0.4574)))
# the native ring feeding the serving receiver: LTE1024, 16 chunks of 65280,
# written in pieces of at most 4095 samples (the reference's work quantum)
NATIVE = ("LTE1024", 65280, 16, 4095)
# the sharded runtime (parallel/), t shards stacked on the card: the RX on
# one frame (config, shard counts); the dp x t chain (config, frames, t) at
# the chain cells' batches; the reacq stream (config, chunk, chunks, t) at
# the serving chunks; the legacy stream (case table, case, candidates,
# injected CFO, chunk, t) at the legacy chunks; two processes on the card
# over gloo (config, frames a process, t)
SHARDED_RX = (("GOLDEN64", (2, 4, 8)), ("LTE1024", (4,)), ("LTE2048", (4,)))
SHARDED_CHAIN = (("GOLDEN64", 128, 2), ("LTE1024", 32, 4))
SHARDED_STREAMS = (("LTE1024", 65280, 16, 4), ("GOLDEN64", 65520, 4, 8))
SHARDED_LEGACY = (("CFO_CASES", 7, (0.0, -1500.0, 1500.0), 1500.0, 63488, 4),
                  ("DSSS_CASES", 9, (0.0,), 0.0, 129024, 2))
MULTIHOST = ("LTE1024", 16, 2)
MULTIHOST_TIMEOUT_S = 300
# "t" across processes (cards_run): the RX cells, the reacq and legacy
# streams and the chain of the sharded phases above, "t" over CARDS_T_PROCS
# processes of CARDS_T_LOCAL shards each
CARDS_RX = (("LTE1024", 4), ("GOLDEN64", 4))
CARDS_STREAM = SHARDED_STREAMS[0]
CARDS_LEGACY = SHARDED_LEGACY[0]
CARDS_CHAIN = ("LTE1024", 32, 4)      # dp 2 x "t" 4
CARDS_T_PROCS = 2
CARDS_REPS = 5                        # RX calls / chain steps a timed round
CARDS_TIMEOUT_S = 300
# the oracle group (oracle_run): the card's paths at full width against the
# port's numpy oracles (reference_cpu/) on the same buffers, made on the
# card and copied to the host.  The subsets the oracles run on: frames of a
# chain cell, pattern blocks of a legacy stream's prefix, streams of a
# tracker cell, exchanges of the PLS cell; together well under 90 s of host
# time
ORACLE_FRAMES = 8
ORACLE_LEGACY_BLOCKS = 64
ORACLE_TRACKER_STREAMS = 4
ORACLE_PLS = 16
SOURCES = {   # kernel -> (CUDA source, the TPU kernel's pallas_call)
    "ofdm_mod": ("lte_gnu_radio_code_tpu_torch/csrc/ofdm_mod.cu",
                 "lte_gnu_radio_code_tpu/pallas_kernels/ofdm_mod.py:165"),
    "channel_conv": ("lte_gnu_radio_code_tpu_torch/csrc/channel_conv.cu",
                     "lte_gnu_radio_code_tpu/pallas_kernels/channel_conv.py:91"),
    "sync_search": ("lte_gnu_radio_code_tpu_torch/csrc/sync_search.cu",
                    "lte_gnu_radio_code_tpu/pallas_kernels/sync_search.py:314"),
    "equalize": ("lte_gnu_radio_code_tpu_torch/csrc/equalize.cu",
                 "lte_gnu_radio_code_tpu/pallas_kernels/equalize.py:142"),
    "tracker": ("lte_gnu_radio_code_tpu_torch/csrc/tracker.cu",
                "no pallas_call: lte_gnu_radio_code_tpu/models/tracker.py:217"),
    "mimo_detect": ("lte_gnu_radio_code_tpu_torch/csrc/mimo_detect.cu",
                    "no pallas_call: XLA in lte_gnu_radio_code_tpu/models/"
                    "mimo.py:rx_frame_mimo"),
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def event_ms(fn, reps: int, evict: bool = True) -> float:
    """Mean device time of fn() over reps launches, by a pair of CUDA events
    around each.  With evict, a 256 MB buffer is read before each launch, so
    fn starts with none of its inputs in the 50 MB L2 and reads them from
    HBM.  The device sleeps while the host queues the timed launches (for
    twice the host's own time to queue them), so that host dispatch, tens of
    microseconds a call, leaves no gaps between kernels shorter than that."""
    buf = torch.empty(L2_EVICT_BYTES // 4, device="cuda") if evict else None

    def queue(events):
        for start, end in events:
            if evict:
                buf.sum()
            start.record()
            fn()
            end.record()

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    queue([(torch.cuda.Event(), torch.cuda.Event()) for _ in range(reps)])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(2 * host_s * SLEEP_CLOCK_HZ))
    queue(events)
    events[-1][1].synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def bound(nbytes: int, ops: float) -> tuple[float, str]:
    """The least ms the card could take: the larger of the bytes at its
    HBM rate and the float32 operations at its peak rate, and which."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def compare(name, kernel_fn, plain_fn, inputs, ops, library_fn, atol,
            rtol=0.0) -> dict:
    """Kernel vs plain twin on the same inputs, then timed in turns
    (plain, kernel, kernel, plain) from a cold L2, then the library call;
    bytes = the inputs read once and the output written once, ops = the
    float32 operations the function needs on these inputs.  Where both
    return a tuple (K4's peaks form: peak, delay), the first output is
    compared and every output counts in the bytes."""
    k, p = kernel_fn(), plain_fn()
    outs = k if isinstance(k, tuple) else (k,)
    k, p = outs[0], (p[0] if isinstance(p, tuple) else p)
    torch.cuda.synchronize()
    if k.shape != p.shape or not bool(torch.isfinite(k).all()):
        raise AssertionError(f"{name}: kernel output {tuple(k.shape)} "
                             f"(finite: {bool(torch.isfinite(k).all())}) vs "
                             f"twin {tuple(p.shape)}")
    err = float((k - p).abs().max())
    if not torch.allclose(k, p, atol=atol, rtol=rtol):
        raise AssertionError(f"{name}: max |kernel - twin| = {err} beyond "
                             f"atol {atol}, rtol {rtol}")
    t = [event_ms(f, TIMING_REPS)
         for f in (plain_fn, kernel_fn, kernel_fn, plain_fn)]
    ms = (t[1] + t[2]) / 2
    nbytes = sum(x.nbytes for x in inputs) + sum(o.nbytes for o in outs)
    bound_ms, bound_by = bound(nbytes, ops)
    return {"max_abs_err": err, "ms": ms, "plain_ms": (t[0] + t[3]) / 2,
            "library_ms": event_ms(library_fn, TIMING_REPS),
            "atol": atol, "rtol": rtol, "bytes": nbytes, "ops": ops,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms,
            "hbm_share": nbytes / (ms * 1e-3) / HBM_BYTES_PER_S}


def planar(x):
    """[B, n] complex -> [B, 2, n] float32 (re, im channels), contiguous."""
    return torch.stack([x.real, x.imag], 1).contiguous()


def fft_flops(rows: int, nfft: int) -> float:
    return rows * 5.0 * nfft * np.log2(nfft)


def k4_least_ops(cfg) -> int:
    """K4's float32 operations a trial in its cheapest known form: the FFT
    form wherever it applies, whichever kernel the rule picks."""
    from lte_gnu_radio_code_tpu_torch.kernels import fft, sync_search

    ops = sync_search.direct_ops(cfg.nfft, cfg.cp_len, cfg.m_synch)
    if fft.takes_fft(cfg.nfft) and cfg.cp_len + 1 <= cfg.nfft:
        ops = min(ops, sync_search.fft_ops(cfg.nfft, cfg.m_synch))
    return ops


def same_peaks(cell, what, peaks, surface) -> None:
    """K4's peaks form (peak, delay) == the same kernel's surface reduced by
    max(-1), peak and delay bit for bit."""
    peak, delay = peaks
    want, at = surface.max(-1)
    same_peak = torch.equal(peak.view(torch.int32), want.view(torch.int32))
    same_delay = torch.equal(delay, at.to(torch.int32))
    if not (same_peak and same_delay):
        raise AssertionError(
            f"{cell}: the {what}'s peaks form vs its surface max(-1): peaks "
            f"equal {same_peak} (max |diff| "
            f"{float((peak - want).abs().max())}), delays equal {same_delay}"
            f" ({int((delay != at).sum())} differ)")


def sync_checks(cfg, batch, rxs, n_trials, cell, zc=None) -> dict:
    """K4 at one main-path shape, in both output forms: the route the rule
    gives it, one launch a call in each form.  The peaks form, the one
    every main path runs, is the row: held to the surface form's max(-1)
    bit for bit (the rule's kernel and the other route's), to the conv-bank
    twin's peaks (timed, with the twin's conv1d alone as the library call),
    with the surface form's ms, and the surface form followed by its
    max(-1), beside it.  The surface form against the twin, the FFT-form
    plain version and the other route's kernel, and all of them against a
    float64 evaluation of the FFT form; bytes, operations and bound of the
    peaks form (the operations of its cheapest known form, whichever kernel
    ran), the product form's bound beside it, and the other route's kernel
    timed on the same input.  ``zc``: the ZC sequence searched for (None:
    the config's own; the MIMO search gives a slice of a longer one)."""
    import torch.nn.functional as F
    from lte_gnu_radio_code_tpu_torch.kernels import sync_search
    from lte_gnu_radio_code_tpu_torch.ops import fast_sync
    from lte_gnu_radio_code_tpu_torch.utils.tables import device_table

    kind = sync_search.route(cfg.nfft, cfg.cp_len, cfg.stride, cfg.m_synch)
    want = "direct" if cfg.stride == 1 else "fft"
    if kind != want:
        raise AssertionError(f"{cell}: sync_search route {kind!r}, expected "
                             f"{want!r} at stride {cfg.stride}")
    other = "fft" if kind == "direct" else "direct"
    outs = {}
    for form, fn in (("surface", sync_search.sync_corr_abs),
                     ("peaks", sync_search.sync_peaks)):
        before = (dict(sync_search.route_launches),
                  dict(sync_search.peak_launches))
        outs[form] = fn(cfg, rxs, n_trials, zc)
        after = (sync_search.route_launches, sync_search.peak_launches)
        grew = [{r: a[r] - b[r] for r in a} for a, b in zip(after, before)]
        if grew != [{kind: 1, other: 0},
                    {kind: int(form == "peaks"), other: 0}]:
            raise AssertionError(f"{cell}: the wrapper did not launch the "
                                 f"{kind} kernel once in the {form} form: "
                                 f"{before} -> {after}")
    k = outs["surface"]
    same_peaks(cell, f"{kind} kernel", outs["peaks"], k)

    tol = (dict(atol=2e-3) if cfg.stride == 1
           else dict(atol=3e-3, rtol=2e-4))
    direct_ops = sync_search.direct_ops(cfg.nfft, cfg.cp_len, cfg.m_synch)
    least_ops = k4_least_ops(cfg)
    w = device_table(fast_sync._conv_weights, rxs.device, cfg,
                     fast_sync.zc_key(zc))
    xr = planar(rxs[:, cfg.cp_len:])

    def surface():
        return sync_search.sync_corr_abs(cfg, rxs, n_trials, zc)

    r = compare(
        "sync_search",
        lambda: sync_search.sync_peaks(cfg, rxs, n_trials, zc),
        lambda: sync_search.sync_peaks_plain(cfg, rxs, n_trials, zc),
        (rxs,),
        ops=float(batch * n_trials * least_ops),
        library_fn=lambda: F.conv1d(xr, w, stride=cfg.stride), **tol)
    r["kernel_route"] = kind
    r["surface_ms"] = event_ms(surface, TIMING_REPS)
    r["surface_max_ms"] = event_ms(lambda: surface().max(-1), TIMING_REPS)
    direct_bound_ms = bound(r["bytes"],
                            float(batch * n_trials * direct_ops))[0]
    r["other_route_ms"] = event_ms(
        lambda: sync_search._launch(other, cfg, rxs, n_trials, zc,
                                    form="peaks"), TIMING_REPS)
    ko = sync_search._launch(other, cfg, rxs, n_trials, zc)
    same_peaks(cell, f"{other} kernel",
               sync_search._launch(other, cfg, rxs, n_trials, zc,
                                   form="peaks"), ko)

    twin = sync_search.sync_corr_abs_plain(cfg, rxs, n_trials, zc)
    if not torch.allclose(k, twin, **tol):
        raise AssertionError(f"{cell}: sync_search {kind} kernel's surface "
                             f"vs the conv-bank twin: max |diff| "
                             f"{float((k - twin).abs().max())} beyond {tol}")
    fplain = sync_search.sync_corr_abs_fft_plain(cfg, rxs, n_trials, zc)
    for what, v in (("FFT-form plain version", fplain),
                    (f"{other} kernel", ko)):
        if not torch.allclose(k, v, **tol):
            raise AssertionError(f"{cell}: sync_search {kind} kernel vs "
                                 f"{what}: max |diff| "
                                 f"{float((k - v).abs().max())} beyond {tol}")
    errs = {"kernel": 0.0, "other": 0.0, "twin": 0.0, "fft_plain": 0.0}
    for i in range(0, batch, 8):      # float64 FFT form, 8 frames at a time
        ref = fast_sync.sync_corr_abs_fft(
            cfg, rxs[i:i + 8].to(torch.complex128), n_trials, zc)
        for key, v in (("kernel", k), ("other", ko), ("twin", twin),
                       ("fft_plain", fplain)):
            errs[key] = max(errs[key],
                            float((v[i:i + 8].double() - ref).abs().max()))
    r["err_vs_float64"] = errs
    r["err_vs_fft_plain"] = float((k - fplain).abs().max())
    print(f"{cell}: sync_search route {kind}, peaks form {r['ms']:.4f} ms "
          f"(== surface max(-1) bit for bit, both routes; surface form "
          f"{r['surface_ms']:.4f} ms, with its max(-1) "
          f"{r['surface_max_ms']:.4f} ms): {r['ops']:.4g} operations in "
          f"the cheapest form, {r['bytes']} bytes, bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
          f"({r['bound_share']:.3f} of it reached; the product form's bound "
          f"{direct_bound_ms:.4f} ms, {direct_bound_ms / r['ms']:.3f}); "
          f"{other} kernel's peaks form on the same input "
          f"{r['other_route_ms']:.4f} ms; surface max |err| vs float64: "
          f"{kind} kernel {errs['kernel']:.3e}, "
          f"{other} kernel {errs['other']:.3e}, conv-bank twin "
          f"{errs['twin']:.3e}, FFT-form plain {errs['fft_plain']:.3e}; "
          f"kernel vs FFT-form plain {r['err_vs_fft_plain']:.3e}")
    return r


def route_cross_checks(dev) -> None:
    """Both K4 kernels at both strides, at small shapes, each against the
    conv-bank twin: the direct kernel at a strided nfft 64 and at nfft 96
    (not a power of two: the rule gives it to the direct kernel), the FFT
    kernel at a dense and a strided nfft 64 with one and two synch symbols,
    and trials past the end of the buffer."""
    import dataclasses
    from lte_gnu_radio_code_tpu_torch.kernels import sync_search
    from lte_gnu_radio_code_tpu_torch.ops import sync
    from lte_gnu_radio_code_tpu_torch.utils import params

    rng = np.random.default_rng(SEED + 2)
    base = dataclasses.replace(params.GOLDEN64, num_ofdm_symb=24)
    cases = [("direct", dataclasses.replace(base, stride=15)),
             ("direct", dataclasses.replace(base, stride=1, synch_dat=(2, 2))),
             ("direct", dataclasses.replace(base, nfft=96, cp_len=24,
                                            num_synch_bins=94, stride=23)),
             ("fft", dataclasses.replace(base, stride=1)),
             ("fft", dataclasses.replace(base, stride=15)),
             ("fft", dataclasses.replace(base, stride=15, synch_dat=(2, 2)))]
    for kind, cfg in cases:
        n = cfg.frame_len + cfg.nfft - 1
        x = torch.from_numpy(
            (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
             ).astype(np.complex64)).to(dev)
        n_trials = sync.n_trials_for(cfg, n) + 7     # some past the buffer
        before = sync_search.route_launches[kind]
        k = sync_search._launch(kind, cfg, x, n_trials)
        p = sync_search.sync_corr_abs_plain(
            cfg, torch.nn.functional.pad(x, (0, 8 * cfg.rx_b_len)), n_trials)
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        if (sync_search.route_launches[kind] != before + 1 or
                not torch.allclose(k, p, atol=3e-3, rtol=2e-4)):
            raise AssertionError(f"sync_search {kind} kernel at nfft "
                                 f"{cfg.nfft} stride {cfg.stride} m_synch "
                                 f"{cfg.m_synch}: max |kernel - twin| {err}")
        rule = sync_search.route(cfg.nfft, cfg.cp_len, cfg.stride, cfg.m_synch)
        print(f"sync_search {kind} kernel at nfft {cfg.nfft} cp {cfg.cp_len} "
              f"stride {cfg.stride} m_synch {cfg.m_synch} (rule: {rule}), "
              f"{n_trials} trials: max |kernel - twin| {err:.3e}")


def k4_link_run(dev, gpu) -> list:
    """:func:`sync_checks` at K4_LINK, on link frames made on the card (a
    frame and the head of the next, :func:`make_streams`); one ``kernels``
    entry, one launch a step."""
    from lte_gnu_radio_code_tpu_torch.models import rxofdm
    from lte_gnu_radio_code_tpu_torch.utils import params

    cfg_name, batch = K4_LINK
    cfg = getattr(params, cfg_name)
    n = cfg.frame_len + cfg.nfft - 1
    n_trials, _ = rxofdm.plan_rx(cfg, n)
    x, _ = make_streams(cfg, batch, n, dev)
    cell = f"{cfg_name} b{batch}"
    c = sync_checks(cfg, batch, x, n_trials, f"{cell} on {gpu}")
    print_kernel_rows(cell, {"sync_search": c})
    return [kernel_entry("sync_search", cell, 1, c)]


def bitwise(t):
    """t with float32 and complex64 elements as int32 words, so that
    torch.equal holds two tensors to the same bits."""
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def chain_graph_run(cfg_name, batch, dev, gpu) -> None:
    """The chain step's graph path at a link cell's shape:
    ``chain_batch`` given ``noise=`` (one replay of the CUDA graph captured
    at the first step of its configuration) against its eager body
    (``chain._chain_batch_eager``) on LINK_SNRS by two input sets of bits
    and unit noise made on the card, stepped in turn as the link cells
    step.  Gates: every output field equal bit for bit, the same launch
    counts, the replays under sync debug mode "error".  Prints the ms a
    step of each (the median of CHAIN_ROUNDS rounds of CHAIN_REPS steps
    ending in a synchronize) and the host's ms to enqueue one step on an
    idle card (the median of CHAIN_REPS)."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.models import chain, rxofdm
    from lte_gnu_radio_code_tpu_torch.utils import params

    base = getattr(params, cfg_name)
    n = base.frame_len + base.nfft - 1
    n_trials, num_patterns = rxofdm.plan_rx(base, n)
    h = chain.loopback_taps(base)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    sets = []
    for _ in range(2):
        bits = torch.randint(0, 2, (batch, base.num_bits), generator=g,
                             device=dev, dtype=torch.int32)
        ri = torch.randn((2, batch, n), generator=g, device=dev)
        sets.append((bits, torch.complex(ri[0], ri[1])))
    cfgs = [dataclasses.replace(base, snr_db=s).validate() for s in LINK_SNRS]
    steps = [(c, b, z) for b, z in sets for c in cfgs]
    cell = f"{cfg_name} b{batch} link"

    def graph(i):
        c, b, z = steps[i % len(steps)]
        return chain.chain_batch(c, h, n_trials, num_patterns, b, noise=z)

    def eager(i):
        c, b, z = steps[i % len(steps)]
        return chain._chain_batch_eager(c, h, n_trials, num_patterns, b,
                                        noise=z)

    t0 = time.perf_counter()
    for i in range(len(cfgs)):                          # the captures
        graph(i)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    outs, counts = {}, {}
    for run in (eager, graph):
        kernels.reset_launch_counts()
        outs[run] = [run(i) for i in range(len(steps))]
        counts[run] = kernels.launch_state()
    if counts[graph] != counts[eager]:
        raise AssertionError(f"{cell}: graph path launch counts "
                             f"{counts[graph]} vs the eager body's "
                             f"{counts[eager]}")
    for i, (a, b) in enumerate(zip(outs[graph], outs[eager])):
        for field in a._fields:
            x, y = getattr(a, field), getattr(b, field)
            if x.shape != y.shape or not torch.equal(bitwise(x), bitwise(y)):
                raise AssertionError(f"{cell}: step {i}'s {field} differs "
                                     "between the graph and the eager body")
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(len(steps)):
            graph(i)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ms, rounds, host = {}, {}, {}
    for run in (eager, graph):
        ms[run], rounds[run] = wall_ms(run)
        queued = []
        for i in range(CHAIN_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(i)
            queued.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        host[run] = sorted(queued)[len(queued) // 2]
    msps = {run: batch * n / t / 1e3 for run, t in ms.items()}
    print(f"{cell} on {gpu}: chain_batch's graph path == its eager body "
          f"on {len(steps)} steps ({len(cfgs)} SNR points x 2 input sets): "
          f"every field bit for bit, launch counts equal, no host sync in a "
          f"replay; {len(cfgs)} captures in {capture_s:.3f} s; "
          f"{ms[graph]:.3f} ms a step (rounds "
          f"{', '.join(f'{t:.3f}' for t in rounds[graph])}), "
          f"{msps[graph]:.3f} Msamples/s, host {host[graph]:.3f} ms to "
          f"enqueue, against eager {ms[eager]:.3f} ms (rounds "
          f"{', '.join(f'{t:.3f}' for t in rounds[eager])}), "
          f"{msps[eager]:.3f} Msamples/s, host {host[eager]:.3f} ms: "
          f"{ms[eager] / ms[graph]:.2f}x")
    busy, launches = profile(graph, f"{cell} graph", top=0)
    print(f"{cell}: graph path device busy {busy:.3f} of {ms[graph]:.3f} ms "
          f"a step, {launches:.1f} device events a step")


def kernel_checks(cfg, batch, dev, cell) -> dict:
    """Each kernel against its twin on real main-path inputs of one cell
    (any modulation and pilot grid)."""
    import torch.nn.functional as F
    from lte_gnu_radio_code_tpu_torch.kernels import (channel_conv, equalize,
                                                      ofdm_mod, sync_search)
    from lte_gnu_radio_code_tpu_torch.models import chain, rxofdm, txofdm
    from lte_gnu_radio_code_tpu_torch.ops import channel, sync
    from lte_gnu_radio_code_tpu_torch.utils.tables import device_table

    rng = np.random.default_rng(SEED)
    bits = torch.as_tensor(rng.integers(0, 2, (batch, cfg.num_bits),
                                        dtype=np.int32), device=dev)
    h = chain.loopback_taps(cfg)
    n_trials, num_patterns = rxofdm.plan_rx(cfg, cfg.frame_len + cfg.nfft - 1)
    out = {}

    rows = txofdm._grid(cfg, bits).reshape(-1, cfg.nfft).contiguous()
    w = device_table(ofdm_mod._idft_mats, dev, cfg.nfft)
    out["ofdm_mod"] = compare(
        "ofdm_mod", lambda: ofdm_mod.modulate_rows(cfg, rows),
        lambda: ofdm_mod.mod_rows_plain(cfg, rows, w), (rows,),
        ops=fft_flops(len(rows), cfg.nfft) + 12.0 * len(rows) * cfg.rx_b_len,
        library_fn=lambda: torch.fft.ifft(rows, dim=-1), atol=2e-5)
    tx = ofdm_mod.modulate_rows(cfg, rows).reshape(batch, cfg.frame_len)

    hw = np.asarray(h, np.complex64)[::-1]             # conv1d correlates
    wk = torch.as_tensor(np.stack([
        np.stack([hw.real, -hw.imag]), np.stack([hw.imag, hw.real])]
    ).astype(np.float32), device=dev)                  # [2, 2, taps]
    txr = planar(tx)
    out["channel_conv"] = compare(
        "channel_conv",
        lambda: channel_conv.apply_channel_frames(tx, h, cfg.nfft),
        lambda: channel_conv.apply_channel_frames_plain(tx, h, cfg.nfft),
        (tx,), ops=8.0 * len(hw) * tx.numel(),
        library_fn=lambda: F.conv1d(txr, wk, padding=len(hw) - 1), atol=1e-5)
    clean = channel_conv.apply_channel_frames(tx, h, cfg.nfft)
    sig_pow = ((tx - tx.mean(1, keepdim=True)).abs() ** 2).mean(1)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rxs = channel.awgn(cfg, clean, sig_pow[:, None], generator=gen)

    out["sync_search"] = sync_checks(cfg, batch, rxs, n_trials, cell)

    ptr, delay, _, _, first = sync.lock_from_peaks(
        cfg, *sync_search.sync_peaks(cfg, rxs, n_trials))
    win = equalize.data_windows(cfg, rxs, ptr, num_patterns)
    if cfg.pilot_grid == "none":
        spec = sync.sync_spectrum_at(cfg, rxs, first)
        _, chan_full, _ = sync.estimate_channel(cfg, spec, delay)
        coeff = equalize.combined_coeff(cfg, delay, chan_full)
    else:       # the pilot equaliser gives K2 the rotation alone
        coeff = equalize.derotation(cfg, delay, dev)
    k = win.shape[1]
    win = win.reshape(batch * k, cfg.nfft)
    coeff = coeff[:, None, :].expand(batch, k, -1).reshape(batch * k, -1)
    out["equalize"] = equalize_check(cfg, win, coeff)
    print_kernel_rows(cell, out)
    return out


def equalize_check(cfg, win, coeff) -> dict:
    """K2 against its plain version on windows [rows, nfft] with one
    coefficient row per window, torch.fft.fft of the windows beside it."""
    from lte_gnu_radio_code_tpu_torch.kernels import equalize
    return compare(
        "equalize", lambda: equalize.demod_windows(cfg, win, coeff),
        lambda: equalize.demod_windows_plain(cfg, win, coeff), (win, coeff),
        ops=fft_flops(len(win), cfg.nfft) + 12.0 * coeff.numel(),
        library_fn=lambda: torch.fft.fft(win, dim=-1), atol=2e-4)


def print_kernel_rows(cell, out) -> None:
    for name, r in out.items():
        print(f"{cell}: {name:13s} kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms  "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({r['bound_share']:.3f} reached)  max|err| "
              f"{r['max_abs_err']:.3e} (atol {r['atol']}, rtol {r['rtol']})  "
              f"{r['bytes']} bytes, {r['hbm_share']:.3f} of 3.35 TB/s "
              f"(L2 evicted)")


def chain_run(cfg, batch, dev, cell, max_ber=0.0) -> dict:
    """The main path: chain_batch with every kernel, reps with the bits
    flipped between reps; then the kernel chain vs the plain chain (the
    same call on CPU copies of the bits and the noise: the kernels'
    twins) on one noise.  Every frame locks, the mean BER stays within
    max_ber (0: no bit differs), and the kernel chain's bits are the plain
    chain's."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.kernels import sync_search
    from lte_gnu_radio_code_tpu_torch.models import chain, rxofdm

    rng = np.random.default_rng(SEED + 1)
    bits = torch.as_tensor(rng.integers(0, 2, (batch, cfg.num_bits),
                                        dtype=np.int32), device=dev)
    h = chain.loopback_taps(cfg)
    n_samples = cfg.frame_len + cfg.nfft - 1
    n_trials, num_patterns = rxofdm.plan_rx(cfg, n_samples)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def step(i):
        return chain.chain_batch(cfg, h, n_trials, num_patterns,
                                 bits ^ (i & 1), generator=gen)

    step(0)                                             # warm-up
    torch.cuda.synchronize()
    times, queued = [], []        # seconds per CHAIN_REPS steps, each round
    for _ in range(CHAIN_ROUNDS):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        results = [step(i) for i in range(CHAIN_REPS)]
        queued.append(time.perf_counter() - t0)         # host done queueing
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]                 # the median round
    counts = kernels.launch_counts()                    # of the last round
    ber = torch.stack([r.ber for r in results])
    found = torch.stack([r.found for r in results])
    if results[0].hard_bits.shape != (batch, cfg.num_bits):
        raise AssertionError(f"hard bits {tuple(results[0].hard_bits.shape)}")
    if not bool(found.all()):
        raise AssertionError(f"{cell}: {int((~found).sum())} frames unlocked")
    if float(ber.mean()) > max_ber:
        raise AssertionError(f"{cell}: mean BER {float(ber.mean())} beyond "
                             f"{max_ber} ({int((ber > 0).sum())} frames with "
                             f"errors, the worst {float(ber.max())})")
    if counts != {**dict.fromkeys(kernels.KERNEL_MODULES, CHAIN_REPS),
                  "tracker": 0, "mimo_detect": 0}:
        raise AssertionError(f"{cell}: launches {counts} over {CHAIN_REPS} "
                             "steps, expected one of each kernel a step")
    routes = dict(sync_search.route_launches)           # of the last round
    want = "direct" if cfg.stride == 1 else "fft"
    if (routes != {"fft": 0, "direct": 0, want: counts["sync_search"]} or
            sync_search.peak_launches != routes):
        raise AssertionError(f"{cell}: sync_search launches by route "
                             f"{routes}, in the peaks form "
                             f"{sync_search.peak_launches}, expected all on "
                             f"{want!r} in the peaks form")

    nr = torch.randn(batch, n_samples, generator=gen, device=dev)
    ni = torch.randn(batch, n_samples, generator=gen, device=dev)
    noise = torch.complex(nr, ni)
    rk = chain.chain_batch(cfg, h, n_trials, num_patterns, bits, noise=noise)
    rp = moved(chain.chain_batch(cfg, h, n_trials, num_patterns, bits.cpu(),
                                 noise=noise.cpu()), dev)
    if not torch.equal(rk.hard_bits, rp.hard_bits):
        n_diff = int((rk.hard_bits != rp.hard_bits).sum())
        raise AssertionError(f"{cell}: kernel vs plain chain: {n_diff} bits "
                             "differ")
    same_lock = int((rk.lock_ptr == rp.lock_ptr).sum())
    same_delay = int((rk.delay_idx == rp.delay_idx).sum())
    msps = CHAIN_REPS * batch * n_samples / dt / 1e6
    rounds = ", ".join(f"{t * 1e3 / CHAIN_REPS:.3f}" for t in times)
    host = ", ".join(f"{t * 1e3 / CHAIN_REPS:.3f}" for t in queued)
    print(f"{cell}: chain_batch x{CHAIN_REPS}: {dt * 1e3 / CHAIN_REPS:.3f} "
          f"ms/step (median of rounds {rounds}; the host alone queued them "
          f"in {host}), {msps:.3f} Msamples/s, all "
          f"{CHAIN_REPS * batch} frames of the last round "
          f"locked, mean BER {float(ber.mean()):.3e} "
          f"({int((ber > 0).sum())} frames with errors, allowed mean "
          f"{max_ber}); launches {counts}, sync_search by route {routes}; "
          f"kernel vs plain chain: bits "
          f"equal, lock_ptr equal {same_lock}/{batch}, delay equal "
          f"{same_delay}/{batch}")
    busy, _ = profile(step, cell)
    print(f"{cell}: device busy {busy:.3f} of {dt * 1e3 / CHAIN_REPS:.3f} "
          f"ms per step: idle share {1 - busy * CHAIN_REPS / (dt * 1e3):.3f}")
    return {"msps": msps, "ms_per_step": dt * 1e3 / CHAIN_REPS,
            "launches": counts}


def profile(step, cell, reps=3, top=12) -> tuple[float, float]:
    """Device time per step by kernel, from a :func:`trace` of reps steps,
    the top kernels and host operators printed; returns the device's busy
    ms and its launches (kernels and copies) per step."""
    prof, seen, made = trace(lambda: [step(i) for i in range(reps)])
    # device kernels only: an operator's row repeats its kernels' time
    rows = sorted(((e.self_device_time_total, e.key)
                   for e in prof.key_averages() if device_work(e)),
                  reverse=True)
    total = sum(t for t, _ in rows)
    launches = seen / reps
    print(f"{cell}: profile of {reps} steps, {len(rows)} device kernels in "
          f"{launches:.1f} launches a step ({seen} device events for {made} "
          f"launch calls of the host"
          f"{'' if seen >= made else ': THE TRACE LOST EVENTS'})"
          f"{':' if top else ''}")
    if not top:
        return total / reps / 1e3, launches
    for t, key in rows[:top]:
        print(f"  {t / reps / 1e3:9.4f} ms/step {100 * t / total:5.1f}%  "
              f"{key[:90]}")
    # the host's side: operators by their own CPU time (profiler on)
    host = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU and
                   e.self_cpu_time_total > 0), reverse=True)
    host_total = sum(t for t, _, _ in host)
    print(f"{cell}: host {host_total / reps / 1e3:.3f} ms/step of operator "
          f"self time in {sum(c for _, c, _ in host) // reps} calls/step "
          f"(profiler on); top:")
    for t, c, key in host[:8]:
        print(f"  {t / reps / 1e3:9.4f} ms/step {c // reps:4d} calls  "
              f"{key[:70]}")
    return total / reps / 1e3, launches


def device_work(e) -> bool:
    """Whether a profiler row is the device's work: a kernel, copy or fill
    on the CUDA device, not a host span's annotation of the device
    timeline (the port's stage spans, ``utils/profiling.py:span``)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA and
            not getattr(e, "is_user_annotation", False) and
            e.self_device_time_total > 0)


def trace(fn):
    """A torch.profiler trace of fn() with the device's events complete:
    (trace, device kernels and copies in it, the host's launch calls in
    it).  The profiler now and then loses a part of a trace's device events
    (a whole step's worth in one of some ten traces on the H100 host), so a
    trace with fewer device events than launch calls is taken again, up to
    PROFILE_TRIES times; the fullest one is returned."""
    from torch.profiler import ProfilerActivity
    best = None
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        seen = sum(e.count for e in events if device_work(e))
        made = sum(e.count for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU and
                   LAUNCH_CALL.match(e.key))
        if best is None or seen > best[1]:
            best = (prof, seen, made)
        if seen >= made:
            break
    return best


def count_launches(fn) -> int:
    """Device kernels and copies that one call of fn() launches."""
    fn()
    torch.cuda.synchronize()
    _, seen, made = trace(fn)
    if seen < made:
        print(f"count_launches: THE TRACE LOST EVENTS ({seen} device events "
              f"for {made} launch calls)")
    return seen


def no_host_sync(rx, chunk, cell) -> None:
    """One push of chunk into receiver rx under torch's sync debug mode
    "error": it raises if anything in the step waits for the host."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        rx.push(chunk)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"{cell}: a chunk step ran with torch's sync debug mode set to "
          "\"error\": nothing in it waits for the host")


def make_streams(cfg, batch, n_samples, dev):
    """batch continuous streams of n_samples on the card: frames of
    different seeded bits through the port's TX (K1), one Fading
    convolution over each whole stream (K3) and AWGN at the config's 100 dB,
    concatenated.  Returns (streams [batch, n_samples], bits [batch,
    frames, num_bits])."""
    from lte_gnu_radio_code_tpu_torch.kernels import channel_conv
    from lte_gnu_radio_code_tpu_torch.models import chain, txofdm
    from lte_gnu_radio_code_tpu_torch.ops import channel

    frames = -(-n_samples // cfg.frame_len)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    bits = torch.randint(0, 2, (batch * frames, cfg.num_bits), generator=gen,
                         device=dev, dtype=torch.int32)
    tx = txofdm.tx_frames(cfg, bits).reshape(batch, -1)
    clean = channel_conv.apply_channel_frames(tx, chain.loopback_taps(cfg),
                                              cfg.nfft)
    sig_pow = ((tx - tx.mean(1, keepdim=True)).abs() ** 2).mean(1)
    rx = channel.awgn(cfg, clean, sig_pow[:, None], generator=gen)
    return rx[:, :n_samples].contiguous(), bits.reshape(batch, frames, -1)


def moved(v, dev):
    """v (a tensor, or a tuple or NamedTuple of them) on device dev; what
    is not a tensor as it is.  A call on CPU copies of its inputs runs the
    kernels' plain twins: the card's run of the same call is held to it."""
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    if isinstance(v, tuple):
        items = [moved(f, dev) for f in v]
        return type(v)(*items) if hasattr(v, "_fields") else tuple(items)
    return v


def stack_outs(outs):
    """Per-step chunk outputs as one output with a leading step axis."""
    return type(outs[0])(*(torch.stack(f) for f in zip(*outs)))


def cat_outs(parts):
    """Outputs that each carry a leading step axis, end to end."""
    return type(parts[0])(*(torch.cat(f) for f in zip(*parts)))


def same_outs(a, b, what, float_atol=None, skip=()) -> float:
    """Two chunk outputs: integer and bool fields equal; float fields equal
    too (float_atol None) or within float_atol times the field's largest
    magnitude where that is above 1 (the peaks reach nfft - 2; phasors and
    channel estimates are of order 1).  Returns the largest float
    difference, as a multiple of that scale."""
    worst = 0.0
    for name in a._fields:
        if name in skip:
            continue
        x, y = getattr(a, name), getattr(b, name)
        if x.shape != y.shape:
            raise AssertionError(f"{what}: {name} {tuple(x.shape)} vs "
                                 f"{tuple(y.shape)}")
        if x.dtype.is_floating_point or x.dtype.is_complex:
            err = float((x - y).abs().max() /
                        y.abs().max().clamp_min(1.0)) if x.numel() else 0.0
            worst = max(worst, err)
            if err > (float_atol or 0.0):
                raise AssertionError(f"{what}: {name} differs by {err} "
                                     f"(allowed {float_atol or 0.0})")
        elif not torch.equal(x, y):
            raise AssertionError(f"{what}: {name} differs in "
                                 f"{int((x != y).sum())} places")
    return worst


def stream_of(outs, b):
    """Stream b of batch outputs [steps, B, ...]."""
    return type(outs)(*(f[:, b] for f in outs))


def check_detections(cfg, outs, bits, n_real, cell, max_bit_err=0.0) -> int:
    """outs [steps, B, det_max, ...] of streams whose first n_real samples
    are real: every pattern block that lies whole inside them is detected
    once (no other detection, none twice), with its data demodulated and
    its hard bits equal to the sent bits (but for a share of at most
    max_bit_err of them).  Returns the detections checked."""
    block = cfg.pattern_len * cfg.rx_b_len
    n_whole = (n_real - cfg.cp_len) // block
    valid = outs.valid.cpu().numpy()
    ptrs = outs.ptrs.cpu().numpy()
    ok = outs.demod_ok.cpu().numpy()
    hard = outs.hard_bits.reshape(*outs.valid.shape, -1).cpu().numpy()
    sent = bits.reshape(bits.shape[0], -1, hard.shape[-1]).cpu().numpy()
    lo, hi, total, wrong = 0, 0, 0, 0
    for b in range(valid.shape[1]):
        v = valid[:, b].reshape(-1)
        p = ptrs[:, b].reshape(-1)[v]
        o = ok[:, b].reshape(-1)[v]
        h = hard[:, b].reshape(len(v), -1)[v]
        j = np.rint((p - cfg.cp_len) / block).astype(np.int64)
        off = p - cfg.cp_len - j * block
        lo, hi = min(lo, int(off.min())), max(hi, int(off.max()))
        if len(np.unique(j)) != len(j) or np.abs(off).max() > cfg.cp_len + \
                cfg.stride:
            raise AssertionError(f"{cell}: stream {b}: a block detected "
                                 f"twice or off a block: offsets {lo}..{hi}")
        if not np.array_equal(np.sort(j[o])[:n_whole], np.arange(n_whole)) \
                or (~o[j < n_whole]).any():
            raise AssertionError(f"{cell}: stream {b}: {o.sum()} blocks "
                                 f"demodulated, expected the first {n_whole}")
        wrong += int((h[o] != sent[b][j[o]]).sum())
        total += int(o.sum())
    n_bits = total * hard.shape[-1]
    if wrong > max_bit_err * n_bits:
        raise AssertionError(f"{cell}: {wrong} of {n_bits} hard bits differ "
                             f"from the sent bits (allowed {max_bit_err} of "
                             "them)")
    print(f"{cell}: every whole pattern block detected once ({n_whole} a "
          f"stream, {total} in all, pointer offsets from the block grid "
          f"{lo}..{hi}), {wrong} of {n_bits} hard bits differ from the sent "
          f"bits (allowed {max_bit_err:g} of them)")
    return total


def graph_replay(cfg, chunks, cell) -> None:
    """The receiver's own graph path (``BatchReacqStreamingRx.push`` on the
    card: one CUDA graph of the chunk step, captured at the first full
    chunk, replayed a chunk) against the eager chain of the functional
    ``reacq_step`` on the same chunks from an empty carry: decisions equal,
    floats within 2e-6, the same launch counts; the ms a step of each, the
    median of SERVING_ROUNDS rounds of the k chunks ending in a
    synchronize."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.runtime import stream as rt

    k, batch, chunk_len = chunks.shape
    rx = rt.BatchReacqStreamingRx(cfg, chunk_len, batch)
    step = functools.partial(rt.reacq_step, cfg, n_real=chunk_len,
                             det_max=rx.det_max)
    rx.push(chunks[0])                                  # the capture

    def eager():
        state = rt.reacq_init(cfg, chunks.device, batch)
        outs = []
        for c in chunks:
            state, out = step(state, c)
            outs.append(out)
        return outs

    def graph():
        for t in rx.state:
            t.zero_()
        return [rx.push(c) for c in chunks]

    counts = []
    for run in (eager, graph):
        kernels.reset_launch_counts()
        outs = stack_outs(run())
        counts.append(kernels.launch_state())
        if run is eager:
            ref = outs
    if counts[0] != counts[1]:
        raise AssertionError(f"{cell}: graph path launch counts {counts[1]} "
                             f"vs the eager chain's {counts[0]}")
    worst = same_outs(outs, ref, f"{cell}: graph path vs eager chain",
                      float_atol=2e-6)
    times = {eager: [], graph: []}
    for _ in range(SERVING_ROUNDS):
        for run in (eager, graph):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times[run].append((time.perf_counter() - t0) * 1e3 / k)
    ms = {run: sorted(t)[len(t) // 2] for run, t in times.items()}
    print(f"{cell}: the receiver's graph path ({k} pushes replaying the "
          f"step captured at its first chunk) == the eager reacq_step "
          f"chain: decisions equal, floats within {worst:.1e}, launch "
          f"counts equal; {ms[graph]:.3f} ms a step (rounds "
          f"{', '.join(f'{t:.3f}' for t in times[graph])}) against "
          f"{ms[eager]:.3f} eager (rounds "
          f"{', '.join(f'{t:.3f}' for t in times[eager])}): "
          f"{ms[eager] / ms[graph]:.2f}x")


def same_as_whole(cfg, outs, stream, n_real, what) -> int:
    """Chunk outputs [steps, det_max, ...] of one stream against
    ``rx_detections`` on the whole buffer (kernel path), up to its last
    detection (the flush probes further): pointers, delays, demod_ok and
    hard bits equal, phasors within 2e-4.  Returns its detections."""
    from lte_gnu_radio_code_tpu_torch.models import stream_rx
    from lte_gnu_radio_code_tpu_torch.ops import sync

    whole = stream_rx.rx_detections(
        cfg, stream, sync.n_trials_for(cfg, n_real),
        max_det=n_real // (cfg.pattern_len * cfg.rx_b_len) + 2)
    nb = int(whole.count)
    v = outs.valid.reshape(-1)
    keep = v & (outs.ptrs.reshape(-1) <= whole.ptrs[:nb].max())
    pick = keep.nonzero()[:, 0]
    for name in ("ptrs", "delays", "demod_ok", "hard_bits", "phasors"):
        x = getattr(outs, name).reshape(len(v), -1)[pick]
        y = getattr(whole, name)[:nb].reshape(nb, -1)
        if x.shape != y.shape or (
                float((x - y).abs().max()) > 2e-4 if x.dtype.is_complex
                else not torch.equal(x, y)):
            raise AssertionError(f"{what} chunk by chunk vs rx_detections "
                                 f"on its whole buffer: {name}")
    return nb


def single_lock_check(cfg, chunks, bits, cell) -> None:
    """The single-lock StreamingRx on one stream, on the card by default:
    it locks on a pattern block (the first whose trial grid gives it a
    window inside the cyclic prefix), the num_patterns blocks from there
    come out once each with the sent bits (bits [frames, num_bits] of the
    stream), one K4 and one K2 launch a step."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.models import stream_rx
    from lte_gnu_radio_code_tpu_torch.runtime import stream as rt

    rx = rt.StreamingRx(cfg, chunks.shape[-1])
    kernels.reset_launch_counts()
    outs = [rx.push(c) for c in chunks] + [rx.finish()]
    counts = kernels.launch_counts()
    ids = torch.cat([o.block_ids for o in outs]).cpu().numpy()
    hard = stream_rx.hard_decide(cfg, torch.cat([o.phasors for o in outs]))
    hard = hard.reshape(len(ids), -1).cpu().numpy()
    got = hard[ids >= 0][np.argsort(ids[ids >= 0])]
    block = cfg.pattern_len * cfg.rx_b_len
    lock = int(outs[-1].lock_ptr)
    first = round((lock - cfg.cp_len) / block)      # the block it locked on
    sent = bits.reshape(-1, hard.shape[-1]).cpu().numpy()[
        first:first + cfg.num_patterns]
    if (not bool(outs[-1].found) or
            abs(lock - cfg.cp_len - first * block) > cfg.cp_len + cfg.stride
            or sorted(ids[ids >= 0]) != list(range(cfg.num_patterns)) or
            not np.array_equal(got, sent) or
            counts["sync_search"] != len(outs) or
            counts["equalize"] != len(outs)):
        raise AssertionError(f"{cell}: StreamingRx: found "
                             f"{bool(outs[-1].found)}, lock {lock}, blocks "
                             f"{sorted(ids[ids >= 0])}, "
                             f"{int((got != sent).sum())} bits differ, "
                             f"launches {counts}")
    print(f"{cell}: StreamingRx (single lock) on stream 0: locked at "
          f"{lock} (pattern block {first}), the {cfg.num_patterns} blocks "
          f"from there out once, bits == sent bits, launches {counts}")


def serving_run(cfg, batch, chunk_len, k, dev, cell, gpu,
                max_bit_err=0.0) -> tuple:
    """The serving path at one shape (module docstring); max_bit_err as in
    :func:`check_detections`.  Returns (launch counts of the main-path run,
    K4 and K2 against their plain versions at this shape)."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.kernels import sync_search
    from lte_gnu_radio_code_tpu_torch.runtime import stream as rt

    n_real = k * chunk_len
    streams, bits = make_streams(cfg, batch, n_real, dev)
    chunks = streams.reshape(batch, k, chunk_len).transpose(0, 1).contiguous()
    want = sync_search.route(cfg.nfft, cfg.cp_len, cfg.stride, cfg.m_synch)

    # -- the main path: the batch receiver as a user builds it --------------
    rx = rt.BatchReacqStreamingRx(cfg, chunk_len, batch)
    rx.push(chunks[0])                                  # warm-up, discarded
    rx = rt.BatchReacqStreamingRx(cfg, chunk_len, batch)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    many = rx.push_many(chunks)
    state_k = type(rx.state)(*(t.clone() for t in rx.state))  # after K
    outs = cat_outs([many, stack_outs(rx.finish())])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    routes = dict(sync_search.route_launches)
    steps = outs.valid.shape[0]
    if (counts["sync_search"] != steps or counts["equalize"] != steps or
            routes != {"fft": 0, "direct": 0, want: steps} or
            sync_search.peak_launches != routes):
        raise AssertionError(f"{cell}: {steps} chunk steps, launches "
                             f"{counts}, sync_search by route {routes}, in "
                             f"the peaks form {sync_search.peak_launches} "
                             f"(expected all on {want!r} in the peaks form)")
    if rx.det_max != rt.reacq_det_max(cfg, chunk_len) or \
            outs.phasors.shape != (steps, batch, rx.det_max,
                                   cfg.synch_dat[1], cfg.num_data_bins) or \
            not bool(torch.isfinite(outs.phasors.abs()).all()):
        raise AssertionError(f"{cell}: phasors {tuple(outs.phasors.shape)}")
    print(f"{cell}: {batch} streams x {k} chunks of {chunk_len} "
          f"(det_max {rx.det_max}) + {steps - k} flush steps: launches "
          f"{counts}, sync_search by route {routes}")
    check_detections(cfg, outs, bits, n_real, cell, max_bit_err)

    # -- kernel path against plain path (CPU copies) on the same streams ----
    prx = rt.BatchReacqStreamingRx(cfg, chunk_len, batch, device="cpu")
    before = kernels.launch_counts()
    plain = moved(cat_outs([prx.push_many(chunks.cpu()),
                            stack_outs(prx.finish())]), chunks.device)
    if kernels.launch_counts() != before:
        raise AssertionError(f"{cell}: the plain path launched a kernel")
    worst = same_outs(outs, plain, f"{cell}: kernel vs plain path",
                      float_atol=2e-4, skip=("peaks",))
    peak_err = float((outs.peaks - plain.peaks).abs().max())
    print(f"{cell}: kernel path == plain path (the CPU twins): ptrs, delays, "
          f"valid, demod_ok, hard bits equal; phasors and chans within "
          f"{worst:.2e} (allowed 2e-4); peaks within {peak_err:.2e}")
    del plain

    # -- push_many == K pushes, exactly --------------------------------------
    srx = rt.BatchReacqStreamingRx(cfg, chunk_len, batch)
    same_outs(stack_outs([srx.push(c) for c in chunks]), many,
              f"{cell}: pushes vs push_many")
    same_outs(srx.state, state_k, f"{cell}: carry after pushes vs push_many")

    # -- one stream alone: == its row of the batch, == the whole buffer,
    #    and resumed from a checkpoint == uninterrupted ----------------------
    b = 3
    one = rt.ReacqStreamingRx(cfg, chunk_len)
    alone = cat_outs([one.push_many(chunks[:, b]), stack_outs(one.finish())])
    werr = same_outs(alone, stream_of(outs, b), f"{cell}: stream {b} alone "
                     "vs in the batch", float_atol=2e-5)
    half = k // 2
    first = rt.ReacqStreamingRx(cfg, chunk_len)
    first.push_many(chunks[:half, b])
    with tempfile.TemporaryDirectory() as tmp:
        first.save_state(f"{tmp}/reacq.npz")
        second = rt.ReacqStreamingRx(cfg, chunk_len)
        second.load_state(f"{tmp}/reacq.npz")
    resumed = cat_outs([second.push_many(chunks[half:, b]),
                        stack_outs(second.finish())])
    same_outs(resumed, type(alone)(*(f[half:] for f in alone)),
              f"{cell}: resumed vs uninterrupted")
    nb = same_as_whole(cfg, alone, streams[b], n_real, f"{cell}: stream {b}")
    print(f"{cell}: push_many == {k} pushes exactly; stream {b} alone == "
          f"its row of the batch (floats within {werr:.1e}); saved after "
          f"{half} chunks, loaded into a new receiver, continued == "
          f"uninterrupted exactly; chunk by chunk == rx_detections on the "
          f"whole buffer ({nb} detections)")
    single_lock_check(cfg, chunks[:3, 0], bits[0], cell)

    # -- no step waits for the host ------------------------------------------
    no_host_sync(srx, chunks[0], cell)

    # -- timing: Msamples/s of a push_many ending in a synchronize -----------
    times = []
    trx = rt.BatchReacqStreamingRx(cfg, chunk_len, batch)
    trx.push(chunks[0])                                 # the capture
    for _ in range(SERVING_ROUNDS):
        for t in trx.state:
            t.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trx.push_many(chunks)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    step_ms = dt * 1e3 / k
    msps = batch * n_real / dt / 1e6
    rounds = ", ".join(f"{t * 1e3 / k:.3f}" for t in times)
    print(f"{cell}: push_many of {k} chunks x {batch} streams: "
          f"{msps:.3f} Msamples/s, {step_ms:.3f} ms a chunk step (median of "
          f"rounds {rounds}) on {gpu}")
    prof_rx = rt.BatchReacqStreamingRx(cfg, chunk_len, batch)
    prof_rx.push(chunks[0])                             # the capture
    busy, launches = profile(lambda i: prof_rx.push(chunks[i % k]), cell)

    # -- the selection's launches, K4 and K2 alone at this shape -------------
    ext, t_per, select, win, coeff, count = step_inputs(cfg, streams,
                                                        chunk_len, rx.det_max)
    sel = count_launches(select)
    print(f"{cell}: device busy {busy:.3f} of {step_ms:.3f} ms a chunk "
          f"step: idle share {1 - busy / step_ms:.3f}; {launches:.1f} device "
          f"launches a step, of which the jump selection "
          f"(refractory_table, {(rx.det_max - 1).bit_length()} rounds) "
          f"{sel}: share {sel / launches:.3f}; {int(count.sum())} of "
          f"{batch * rx.det_max} slots hold a detection in the step that K2 "
          f"is timed on ({len(win)} rows) on {gpu}")
    checks = {"sync_search": sync_checks(cfg, batch, ext, t_per, cell),
              "equalize": equalize_check(cfg, win, coeff)}
    print_kernel_rows(cell, checks)
    graph_replay(cfg, chunks, cell)
    return counts, checks


def step_inputs(cfg, streams, chunk_len, det_max) -> tuple:
    """What K4 and K2 get in a multi-detection receiver's second chunk step
    on streams [B, n]: ext [B, lag + chunk_len] and its trials, the jump
    selection as a closure (run once here), K2's windows [rows, nfft] with
    one coefficient row each, and the detections a stream [B]."""
    from lte_gnu_radio_code_tpu_torch.models import stream_rx
    from lte_gnu_radio_code_tpu_torch.ops import sync
    from lte_gnu_radio_code_tpu_torch.runtime import stream as rt

    batch, dev = streams.shape[0], streams.device
    lag = rt.reacq_lag(cfg)
    ext = streams[:, chunk_len - lag:2 * chunk_len].contiguous()
    t_per = chunk_len // max(1, cfg.stride)
    dmax_val, dmax_ind = stream_rx.detect_trials(cfg, ext, t_per)
    local_ptrs = cfg.cp_len + max(1, cfg.stride) * torch.arange(t_per,
                                                                 device=dev)
    crossing = dmax_val > sync.gate_level(cfg)
    carry = (torch.zeros(batch, dtype=torch.int32, device=dev),
             torch.zeros(batch, dtype=torch.bool, device=dev))

    def select():
        return sync.refractory_table(cfg, crossing, (local_ptrs, dmax_ind,
                                                     dmax_val), det_max,
                                     cfg.cp_len, *carry)

    _, (l_ptrs, delays, _), count, _ = select()
    valid = torch.arange(det_max, device=dev) < count[:, None]
    _, _, dwin, coeff = stream_rx.detection_rows(
        cfg, ext, l_ptrs, delays, valid, ext.shape[-1])
    nd, nb = cfg.synch_dat[1], cfg.num_data_bins
    win = dwin.reshape(-1, cfg.nfft)
    coeff = coeff[:, :, None, :].expand(batch, det_max, nd, nb).reshape(
        -1, nb).contiguous()
    return ext, t_per, select, win, coeff, count


def config_of(source, changes):
    """A cell's configuration: a ``configs/*.json`` file, or a shipped
    configuration by name with some fields changed."""
    import dataclasses
    from lte_gnu_radio_code_tpu_torch.cli import ber_sweep
    from lte_gnu_radio_code_tpu_torch.utils import params
    if source.endswith(".json"):
        return params.OFDMConfig(
            **ber_sweep.load_config(REPO / source)).validate()
    return dataclasses.replace(getattr(params, source),
                               **(changes or {})).validate()


def noisy_chain_check(cfg, batch, dev, cell) -> None:
    """The chain at the config's own SNR, where frames carry bit errors:
    every frame locks, and on one noise tensor the kernel chain and the
    plain chain (the same call on CPU copies) decide at most 1e-4 of the
    bits otherwise (a phasor next to a decision threshold may fall on
    either side)."""
    from lte_gnu_radio_code_tpu_torch.models import chain, rxofdm

    rng = np.random.default_rng(SEED + 5)
    bits = torch.as_tensor(rng.integers(0, 2, (batch, cfg.num_bits),
                                        dtype=np.int32), device=dev)
    n_samples = cfg.frame_len + cfg.nfft - 1
    n_trials, num_patterns = rxofdm.plan_rx(cfg, n_samples)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    noise = torch.complex(
        torch.randn(batch, n_samples, generator=gen, device=dev),
        torch.randn(batch, n_samples, generator=gen, device=dev))
    h = chain.loopback_taps(cfg)
    rk = chain.chain_batch(cfg, h, n_trials, num_patterns, bits, noise=noise)
    rp = moved(chain.chain_batch(cfg, h, n_trials, num_patterns, bits.cpu(),
                                 noise=noise.cpu()), dev)
    differ = float((rk.hard_bits != rp.hard_bits).float().mean())
    ber_k, ber_p = float(rk.ber.mean()), float(rp.ber.mean())
    if (not bool(rk.found.all()) or not bool(rp.found.all()) or
            differ > 1e-4 or not 0.0 < ber_k < 0.1):
        raise AssertionError(f"{cell} at {cfg.snr_db} dB: "
                             f"{int((~rk.found).sum())} frames unlocked, "
                             f"BER {ber_k} (kernel) {ber_p} (plain), "
                             f"{differ} of the bits differ")
    print(f"{cell} at {cfg.snr_db} dB: all {batch} frames locked, BER "
          f"{ber_k:.6f} on the kernel chain, {ber_p:.6f} on the plain chain "
          f"on the same noise; {differ:.2e} of the bits differ (allowed "
          f"1e-4); lock_ptr equal {int((rk.lock_ptr == rp.lock_ptr).sum())}"
          f"/{batch}")


def qam_run(name, source, changes, batch, max_ber, dev, gpu) -> list:
    """One QAM / pilot chain cell (module docstring): its kernels against
    their plain versions at its shapes, then ``chain_run``'s gates and
    numbers at 100 dB, then the noisy run where the config has its own
    SNR.  Returns the cell's entries of the ``kernels`` line."""
    import dataclasses
    own = config_of(source, changes)
    cfg = dataclasses.replace(own, snr_db=100.0)
    cell = f"{name} b{batch}"
    checks = kernel_checks(cfg, batch, dev, cell)
    run = chain_run(cfg, batch, dev, cell, max_ber)
    print(f"{cell}: {run['msps']:.3f} Msamples/s on {gpu}")
    if own.snr_db != cfg.snr_db:
        noisy_chain_check(own, batch, dev, cell)
    return [kernel_entry(k, cell, run["launches"][k], c)
            for k, c in checks.items()]


def make_legacy_stream(cfg, n_samples, dsss, cfo_hz, dev):
    """One continuous stream of n_samples for the legacy receivers, made on
    the card: seeded QPSK symbols, each spread over ``dsss`` bins by the
    ZC spreading code, one data symbol a pattern block, through the port's
    grid and K1, one Fading convolution over the whole stream (K3), a
    carrier offset of cfo_hz over the whole stream, and noise
    LEGACY_NOISE_DB under the signal.  Returns (stream [n_samples], symbols
    [blocks, num_data_bins / dsss])."""
    from lte_gnu_radio_code_tpu_torch.kernels import channel_conv, ofdm_mod
    from lte_gnu_radio_code_tpu_torch.models import chain
    from lte_gnu_radio_code_tpu_torch.ops import cfo, modulation, ofdm
    from lte_gnu_radio_code_tpu_torch.utils.tables import device_table

    frames = -(-n_samples // cfg.frame_len)
    n_sym = cfg.num_data_bins // dsss
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    bits = torch.randint(0, 2, (frames, cfg.num_data_symb, 2 * n_sym),
                         generator=gen, device=dev, dtype=torch.int32)
    pts = modulation.bits_to_symbols(bits, "QPSK")
    code = device_table(cfo.dsss_code, dev, dsss)
    chips = (pts[..., None] * code).reshape(frames, cfg.num_data_symb, -1)
    rows = ofdm.resource_grid(cfg, chips).reshape(-1, cfg.nfft)
    tx = ofdm_mod.modulate_rows(cfg, rows.contiguous()).reshape(1, -1)
    clean = channel_conv.apply_channel_frames(
        tx, chain.loopback_taps(cfg), cfg.nfft)[0, :n_samples]
    t = torch.arange(n_samples, device=dev, dtype=torch.float64)
    mixer = torch.exp(1j * (2 * np.pi * cfo_hz / cfg.fs) * t).to(
        torch.complex64)
    sigma = float(torch.sqrt(tx.abs().pow(2).mean() *
                             10 ** (-LEGACY_NOISE_DB / 10) / 2))
    noise = torch.complex(
        torch.randn(n_samples, generator=gen, device=dev),
        torch.randn(n_samples, generator=gen, device=dev))
    return ((clean * mixer + sigma * noise).contiguous(),
            pts.reshape(-1, n_sym))


def on_grid(cfg, ptrs):
    """ptrs (numpy) -> (the nearest pattern block of each, whether the
    pointer lies within cp + stride of that block's start)."""
    block = cfg.pattern_len * cfg.rx_b_len
    j = np.rint((ptrs - cfg.cp_len) / block).astype(np.int64)
    return j, np.abs(ptrs - cfg.cp_len - j * block) <= cfg.cp_len + cfg.stride


def check_legacy_detections(cfg, outs, sent, n_real, want_fo, every_block,
                            cell) -> int:
    """outs [steps, det_max, ...] of one legacy stream whose first n_real
    samples are real.  A detection is on the grid when its pointer lies
    within cp + stride of a pattern block's start; no block is detected
    twice.  With ``every_block`` (no carrier offset left after the mixer):
    there is no other detection, every detection chose the CFO candidate
    ``want_fo``, every block whose data symbol lies whole inside the real
    samples is detected and demodulated, and the signs of its despread
    symbols are the sent symbols'.  Without it (an offset that turns the
    phase from one synch window to the next: the trial sum loses part of
    its peak, some blocks stay under the gate, the sequence's ambiguity two
    symbols early crosses it, and candidates one step apart nearly tie, as
    in the JAX package): at least half of those blocks, and at least 99 in
    100 of the detections on the grid on candidate ``want_fo``.  Returns
    the detections on the grid."""
    block = cfg.pattern_len * cfg.rx_b_len
    reach = cfg.m_synch * cfg.rx_b_len + cfg.nfft
    n_whole = (n_real - cfg.cp_len - reach) // block + 1
    v = outs.valid.reshape(-1).cpu().numpy()
    p = outs.ptrs.reshape(-1).cpu().numpy()[v]
    o = outs.demod_ok.reshape(-1).cpu().numpy()[v]
    fo = outs.fo_idx.reshape(-1).cpu().numpy()[v]
    d = outs.despread.reshape(len(v), -1).cpu().numpy()[v]
    j, on = on_grid(cfg, p)
    whole = on & (j < n_whole)
    other = int((fo[on] != want_fo).sum())
    if len(np.unique(j[on])) != int(on.sum()) or \
            other > (0 if every_block else int(on.sum()) // 100):
        raise AssertionError(f"{cell}: {int(on.sum())} detections on the "
                             f"grid for {len(np.unique(j[on]))} blocks, "
                             f"{other} of them not on candidate {want_fo}")
    if every_block:
        s = sent.cpu().numpy()[j[whole]]
        wrong = int(((d[whole].real > 0) != (s.real > 0)).sum() +
                    ((d[whole].imag > 0) != (s.imag > 0)).sum())
        if (not on.all() or not np.array_equal(np.sort(j[whole]),
                                               np.arange(n_whole))
                or not o[whole].all() or wrong):
            raise AssertionError(
                f"{cell}: {int((~on).sum())} detections off the grid, "
                f"{int(whole.sum())} of {n_whole} whole blocks detected, "
                f"{int((~o[whole]).sum())} not demodulated, {wrong} despread "
                "symbol signs differ from the sent ones")
        print(f"{cell}: every whole pattern block detected once ({n_whole}), "
              f"no other detection, every fo_idx {want_fo}, the signs of "
              f"all {d[whole].size} despread symbols == the sent symbols'")
    else:
        if int(whole.sum()) < n_whole // 2:
            raise AssertionError(f"{cell}: {int(whole.sum())} of {n_whole} "
                                 "whole blocks detected, expected at least "
                                 "half")
        print(f"{cell}: {int(whole.sum())} of {n_whole} whole pattern blocks "
              f"detected on the grid, none twice, {int(on.sum()) - other} of "
              f"{int(on.sum())} detections there on candidate {want_fo} "
              f"(candidates {np.bincount(fo[on], minlength=1).tolist()}); "
              f"{int((~on).sum())} detections off the grid (candidates "
              f"{np.bincount(fo[~on], minlength=1).tolist()})")
    return int(on.sum())


def legacy_chunks(cfg) -> tuple[int, int]:
    """(chunk length, chunks) of a legacy stream: LEGACY_CHUNK_STRIDES
    strides a chunk, at least LEGACY_SAMPLES samples."""
    chunk_len = LEGACY_CHUNK_STRIDES * cfg.stride
    return chunk_len, -(-LEGACY_SAMPLES // chunk_len)


def legacy_run(table, case, fo_range, cfo_hz, dev, gpu, timed) -> tuple:
    """``LegacyStreamingRx`` at one legacy case (module docstring).  Returns
    (cell name, K2 launches of the main-path run, K2 against its plain
    version at this shape, or None where not ``timed``)."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.models import legacy_rx
    from lte_gnu_radio_code_tpu_torch.ops import cfo, sync
    from lte_gnu_radio_code_tpu_torch.runtime import stream as rt
    from lte_gnu_radio_code_tpu_torch.utils import params

    cases = getattr(params, table)
    cfg = params.config_from_case(cases, case)
    dsss = cases[case]["dsss"]
    chunk_len, k = legacy_chunks(cfg)
    n_real = k * chunk_len
    cell = (f"{table[:-6]} case {case} (nfft {cfg.nfft}, synch_dat "
            f"{cfg.synch_dat}, dsss {dsss}, {len(fo_range)} candidates, "
            f"{cfo_hz:+.0f} Hz)")
    stream, sent = make_legacy_stream(cfg, n_real, dsss, cfo_hz, dev)
    chunks = stream.reshape(k, chunk_len)
    make = functools.partial(rt.LegacyStreamingRx, cfg, chunk_len,
                             fo_range=fo_range, dsss=dsss)

    # -- the main path: the receiver as a user builds it, on the card --------
    make().push(chunks[0])                              # warm-up, discarded
    rx = make()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    many = rx.push_many(chunks)
    outs = cat_outs([many, stack_outs(rx.finish())])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    steps = outs.valid.shape[0]
    if counts != {**dict.fromkeys(kernels.KERNEL_MODULES, 0),
                  "equalize": steps}:
        raise AssertionError(f"{cell}: {steps} chunk steps, launches "
                             f"{counts}, expected one K2 launch a step and "
                             "no other kernel")
    if outs.phasors.shape != (steps, rx.det_max, cfg.num_data_bins) or \
            not bool(torch.isfinite(outs.phasors.abs()).all()):
        raise AssertionError(f"{cell}: phasors {tuple(outs.phasors.shape)}")
    print(f"{cell}: {k} chunks of {chunk_len} ({n_real} samples, det_max "
          f"{rx.det_max}) + {steps - k} flush steps: launches {counts}")
    want_fo = fo_range.index(-cfo_hz) if cfo_hz else 0
    check_legacy_detections(cfg, outs, sent, n_real, want_fo,
                            every_block=not cfo_hz, cell=cell)

    # -- K2 path against plain path (CPU copies), push_many against pushes --
    prx = make(device="cpu")
    before = kernels.launch_counts()
    plain = moved(cat_outs([prx.push_many(chunks.cpu()),
                            stack_outs(prx.finish())]), dev)
    if kernels.launch_counts() != before:
        raise AssertionError(f"{cell}: the plain path launched a kernel")
    worst = same_outs(outs, plain, f"{cell}: K2 path vs plain path",
                      float_atol=2e-4)
    srx = make()
    same_outs(stack_outs([srx.push(c) for c in chunks]), many,
              f"{cell}: pushes vs push_many")

    # -- chunk by chunk == the whole buffer -----------------------------------
    block = cfg.pattern_len * cfg.rx_b_len
    whole = legacy_rx.make_legacy_rx(cfg, n_real, fo_range=fo_range,
                                     dsss=dsss, max_det=2 * (n_real // block))(
        stream)
    nb = int(whole.count)
    v = outs.valid.reshape(-1)
    keep = v & (outs.ptrs.reshape(-1) <= whole.ptrs[:nb].max())
    pick = keep.nonzero()[:, 0]
    on = torch.as_tensor(on_grid(cfg, whole.ptrs[:nb].cpu().numpy())[1],
                         device=dev)
    worst_whole = 0.0
    for name, wname in (("ptrs", "ptrs"), ("delays", "delays"),
                        ("fo_idx", "fo_idx"), ("chans", "chan_freq"),
                        ("phasors", "phasors"), ("despread", "despread")):
        x = getattr(outs, name).reshape(len(v), -1)[pick]
        y = getattr(whole, wname)[:nb].reshape(nb, -1)
        what = f"{cell}: chunk by chunk vs rx_frame_cfo on the whole buffer"
        if x.shape != y.shape:
            raise AssertionError(f"{what}: {name} {tuple(x.shape)} vs "
                                 f"{tuple(y.shape)}")
        if not x.dtype.is_complex:
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: {name} differs in "
                                     f"{int((x != y).sum())} places")
            continue
        if name != "chans":
            # a detection off the grid has a channel estimate of noise, and
            # 1 / H at snr 1e8 turns a last-bit difference into any size
            x, y = x[on], y[on]
        err = float(((x - y).abs() / y.abs().clamp_min(1.0)).max())
        worst_whole = max(worst_whole, err)
        if err > 2e-4:
            raise AssertionError(
                f"{what}: {name} differ by {err:.3e} of max(1, |value|) "
                f"(largest |value| {float(y.abs().max()):.3e}, largest "
                f"difference {float((x - y).abs().max()):.3e})")
    print(f"{cell}: K2 path == plain path (CPU copies): tables and masks "
          f"equal, floats within {worst:.2e} (allowed 2e-4); push_many == {k} "
          f"pushes exactly; chunk by chunk == rx_frame_cfo on the whole "
          f"buffer ({nb} detections: pointers, delays and candidates equal, "
          f"channels of all and phasors and despread symbols of the "
          f"{int(on.sum())} on the grid within {worst_whole:.2e} of "
          f"max(1, |value|), allowed 2e-4)")

    # -- no step waits for the host -------------------------------------------
    no_host_sync(srx, chunks[0], cell)
    if not timed:
        return cell, counts["equalize"], None

    # -- timing, profile, and K2 alone at this shape --------------------------
    step_ms, times, busy, launches = stream_times(make, chunks, cell, top=12)
    rounds = ", ".join(f"{t:.3f}" for t in times)
    print(f"{cell}: push_many of {k} chunks: "
          f"{n_real / step_ms / 1e3:.3f} Msamples/s, {step_ms:.3f} ms a chunk "
          f"step (median of rounds {rounds}) on {gpu}")
    print(f"{cell}: device busy {busy:.3f} of {step_ms:.3f} ms a chunk step: "
          f"idle share {1 - busy / step_ms:.3f}; {launches:.1f} device "
          f"launches a step on {gpu}")

    lag = rt.legacy_lag(cfg)
    ext = stream[chunk_len - lag:2 * chunk_len].contiguous()
    bank = cfo.bank_on(cfg, fo_range, dev)
    t_per = chunk_len // cfg.stride
    dmax_val, delay_win, fo_win = cfo.cfo_search_scan(cfg, ext, t_per, bank)
    ptrs, (delays, fo_sel), count = sync.refractory_detect(
        cfg, dmax_val, (delay_win, fo_win), rx.det_max)
    valid = torch.arange(rx.det_max, device=dev) < count
    spec = cfo.spectra_at_detections(cfg, ext, torch.where(valid, ptrs, 0),
                                     fo_sel, bank)
    _, chans, _ = sync.estimate_channel(cfg, spec, delays.to(torch.int64))
    start = torch.where(valid, ptrs + cfg.m_synch * cfg.rx_b_len, 0)
    win = (sync.windows_at(ext, start, torch.arange(cfg.nfft, device=dev)) *
           cfo.bank_select(bank, fo_sel)).contiguous()
    from lte_gnu_radio_code_tpu_torch.kernels import equalize
    coeff = (equalize.combined_coeff(cfg, delays, chans * valid[:, None]) *
             valid[:, None]).contiguous()
    check = equalize_check(cfg, win, coeff)
    print_kernel_rows(cell, {"equalize": check})
    return cell, counts["equalize"], check


def dependent_load_ms(dev) -> float:
    """Device ms of one dependent global load: a Triton kernel chases a
    random cycle through a CHASE_BYTES ring of int32 (held in the L2 after
    the first lap), CHASE_STEPS loads each waiting for the one before.  A
    yardstick of the tracker's bound; the port does not use Triton."""
    import triton
    import triton.language as tl

    @triton.jit
    def chase(nxt, out, steps):
        i = tl.load(nxt)
        for _ in range(steps):
            i = tl.load(nxt + i)
        tl.store(out, i)

    n = CHASE_BYTES // 4
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(SEED))
    ring = torch.empty(n, dtype=torch.int32)
    ring[perm] = torch.roll(perm, -1).to(torch.int32)
    ring = ring.to(dev)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    run = lambda: chase[(1,)](ring, out, CHASE_STEPS)
    for _ in range(2):                      # compile, then one warm lap
        run()
    return event_ms(run, 5, evict=False) / CHASE_STEPS


def tracker_streams(cfg, batch, snr_db, dev):
    """batch buffers of one frame each (frame_len + nfft - 1 samples), made
    on the card as the JAX bench makes them (bench_generations.py:175):
    seeded bits through K1, the Fading convolution (K3) and AWGN at
    snr_db.  Returns (buffers [batch, n], bits [batch, num_bits])."""
    import dataclasses
    from lte_gnu_radio_code_tpu_torch.kernels import channel_conv
    from lte_gnu_radio_code_tpu_torch.models import chain, txofdm
    from lte_gnu_radio_code_tpu_torch.ops import channel

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bits = torch.randint(0, 2, (batch, cfg.num_bits), generator=gen,
                         device=dev, dtype=torch.int32)
    tx = txofdm.tx_frames(cfg, bits)
    clean = channel_conv.apply_channel_frames(tx, chain.loopback_taps(cfg),
                                              cfg.nfft)
    sig_pow = ((tx - tx.mean(1, keepdim=True)).abs() ** 2).mean(1)
    rx = channel.awgn(dataclasses.replace(cfg, snr_db=snr_db), clean,
                      sig_pow[:, None], generator=gen)
    return rx.contiguous(), bits


def same_track(a, b, what) -> tuple[float, float, float]:
    """Two TrackResults: count, ptrs, delays and hard bits equal; peaks
    within 1e-5 of their size, channels within 1e-5, phasors within 2e-4
    (the JAX package's tolerances).  Returns the three float errors."""
    for name in ("count", "ptrs", "delays", "hard_bits"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"{what}: {name} differs in "
                                 f"{int((getattr(a, name) != getattr(b, name)).sum())}"
                                 " places")
    errs = (float(((a.peaks - b.peaks).abs() /
                   b.peaks.abs().clamp_min(1.0)).max()),
            float((a.chan_freq - b.chan_freq).abs().max()),
            float((a.phasors - b.phasors).abs().max()))
    for err, tol, name in zip(errs, (1e-5, 1e-5, 2e-4),
                              ("peaks", "chans", "phasors")):
        if err > tol:
            raise AssertionError(f"{what}: {name} differ by {err:.3e} "
                                 f"(allowed {tol})")
    return errs


def tracker_check(cfg, xs, steps, max_det, kind, ref, cell, x_start=0,
                  fire_limit=None, carry=None) -> float:
    """The tracker kernel of route ``kind`` against a scan ``ref`` = (carry,
    ys) on the same inputs (by default the whole buffer from a fresh
    carry): every carry field's bits, accept, pointer and delay at every
    step equal; peaks within 1e-5 of their size and the compacted channel
    table within 1e-5.  Returns the larger float error."""
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.models import tracker

    if carry is None:
        carry = tracker.tracker_init_carry(len(xs), xs.device)
    ck, yk = ktrk._launch(kind, cfg, xs, x_start,
                          xs.shape[1] if fire_limit is None else fire_limit,
                          carry, steps, max_det)
    cp_, yp = ref
    for nm, a, b in zip(("accept", "ptr", "delay"), yk, yp):
        if not torch.equal(a, b):
            raise AssertionError(f"{cell}: the {kind} route's {nm} differs "
                                 f"in {int((a != b).sum())} steps")
    for nm, a, b in zip(tracker.TrackerCarry._fields, ck, cp_):
        if not torch.equal(a, b):
            raise AssertionError(f"{cell}: the {kind} route's carry {nm} "
                                 "differs")
    peak_err = float(((yk[3] - yp[3]).abs() /
                      yp[3].abs().clamp_min(1.0)).max())
    h_err = float((yk[4] - yp[4]).abs().max())
    if peak_err > 1e-5 or h_err > 1e-5:
        raise AssertionError(f"{cell}: the {kind} route's peaks within "
                             f"{peak_err:.3e}, channel table within "
                             f"{h_err:.3e} (allowed 1e-5)")
    return max(peak_err, h_err)


def tracker_work(cfg, xs, scan, x_start=0, carry_in=None) -> tuple:
    """What the tracker's scan (carry, ys) over xs needed, whichever kernel
    ran it (xs[0] at global sample ``x_start``, from the carry ``carry_in``,
    by default a fresh one).  A step that does not fire leaves the carry as
    it was, so every later step of the call repeats it: a stream computes
    its fired steps (the loop count's growth) and at most one more.
    Returns (computed steps [B]; bytes: the samples the computed steps'
    windows read, each once, the carry read and written, the step outputs
    and the channel table written; float32 operations of each computed
    step's cheapest form: m_synch forward FFTs, the product q = X conj(zc)
    over the synch bins, the power and normalisation, and the correlations
    at every delay as one inverse FFT of q scattered to its bins, with the
    cp + 1 magnitudes)."""
    carry, ys = scan
    batch, n = xs.shape
    steps = ys[0].shape[1]
    fired = carry.loop_count.to(torch.int64)
    if carry_in is not None:
        fired = fired - carry_in.loop_count.to(torch.int64)
    computed = torch.clamp(fired + 1, max=steps)
    span = (cfg.m_synch - 1) * cfg.rx_b_len + cfg.nfft
    local = ys[1].to(torch.int64) - torch.as_tensor(
        x_start, device=xs.device).to(torch.int64).reshape(-1, 1)
    starts = torch.where(torch.arange(steps, device=xs.device) < fired[:, None],
                         local, 0)              # the frozen step: x[0]
    idx = (starts[..., None] + torch.arange(span, device=xs.device)).clamp(
        0, n - 1).reshape(batch, -1)
    read = torch.zeros(batch, n, dtype=torch.bool, device=xs.device)
    read.scatter_(1, idx, True)
    nbytes = (int(read.sum()) * xs.element_size() +
              2 * sum(c.nbytes for c in carry) + sum(y.nbytes for y in ys))
    l_syn, d = cfg.m_synch * cfg.num_synch_bins, cfg.cp_len + 1
    ops = int(computed.sum()) * (
        (cfg.m_synch + 1) * 5.0 * cfg.nfft * np.log2(cfg.nfft) +
        8.0 * l_syn + 16.0 * l_syn + 3.0 * d)
    return computed, nbytes, ops


def call_ms(fn) -> tuple[float, list]:
    """Host ms of fn() ending in a synchronize: median of SERVING_ROUNDS."""
    times = []
    for _ in range(SERVING_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], times


def tracker_main_path(cfg, xs, bits, kind, cell) -> tuple:
    """``make_tracker`` on the card as a user calls it: once to warm up,
    then with the launch counts from 0: one tracker launch on route
    ``kind`` and one K2 launch, every pattern block detected in every
    stream with the sent bits.  Returns (the tracker, its result, the
    launch counts)."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.models import tracker

    if ktrk.route(cfg) != kind:
        raise AssertionError(f"{cell}: route {ktrk.route(cfg)}, expected "
                             f"{kind}")
    track = tracker.make_tracker(cfg, xs.shape[1])
    track(xs)                                           # warm-up, discarded
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    r = track(xs)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    routes = dict(ktrk.route_launches)
    want = {**dict.fromkeys(kernels.KERNEL_MODULES, 0), "tracker": 1,
            "equalize": 1}
    wrong = int((r.hard_bits[:, :cfg.num_bits] != bits).sum())
    if (counts != want or routes[kind] != 1 or sum(routes.values()) != 1 or
            not bool((r.count == cfg.num_patterns).all()) or wrong):
        raise AssertionError(f"{cell}: launches {counts} (expected {want}), "
                             f"routes {routes}, detections "
                             f"{r.count.tolist()[:8]}, {wrong} bits differ "
                             "from the sent bits")
    print(f"{cell}: {len(xs)} buffers of {xs.shape[1]} samples: "
          f"{cfg.num_patterns} detections a stream, BER 0, launches "
          f"{counts}, tracker route {kind}")
    return track, r, counts


def tracker_plain(cfg, xs, steps, max_det, r, cell) -> tuple:
    """The plain path once, eager and timed: ``track_scan_plain`` and the
    rest of ``track_frame`` on CPU copies of its outputs (K2's plain
    twin); it launches no kernel and equals the kernel path ``r``
    (``same_track``).
    Returns (the plain scan, its ms, the float errors of r against it)."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.models import tracker

    before = kernels.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan = ktrk.track_scan_plain(cfg, xs, 0, xs.shape[1],
                                 tracker.tracker_init_carry(len(xs), xs.device),
                                 steps, max_det)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    p = moved(tracker.track_result(cfg, xs.cpu(), moved(scan[1], "cpu")),
              xs.device)
    if kernels.launch_counts() != before:
        raise AssertionError(f"{cell}: the plain path launched a kernel")
    errs = same_track(r, p, f"{cell}: kernel path vs plain path")
    return scan, plain_ms, errs


def tracker_run(dev, gpu, load_ms) -> list:
    """The tracker on whole buffers (``models.tracker.make_tracker``, the
    card's path: one launch of the step-loop kernel and one of K2 a call)
    at GOLDEN64 B 16 (module docstring), on the warp route: 60 detections a
    stream, BER 0, kernel path == plain path, both routes' scans == the
    plain twin's; times: the call, each route's kernel, the plain loop
    eager, and a profile of one call; ``load_ms`` is one dependent L2 load
    (:func:`dependent_load_ms`).  Then the card-filling batch (8
    streams on each SM), warp route == block route there, and its times.
    Returns the ``kernels`` entries."""
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.models import tracker
    from lte_gnu_radio_code_tpu_torch.utils import params

    name, batch, snr_db = TRACKER
    cfg = getattr(params, name)
    cell = f"{name} tracker b{batch}"
    max_det = cfg.num_patterns
    xs, bits = tracker_streams(cfg, batch, snr_db, dev)
    n = xs.shape[1]
    steps = int(np.ceil(n / tracker.tracker_stride(cfg))) + 1
    carry0 = tracker.tracker_init_carry(batch, dev)

    # -- the main path, then the plain path and both routes against it -------
    track, r, counts = tracker_main_path(cfg, xs, bits, "warp", cell)
    scan, plain_ms, errs = tracker_plain(cfg, xs, steps, max_det, r, cell)
    err = {kind: tracker_check(cfg, xs, steps, max_det, kind, scan, cell)
           for kind in ("warp", "block")}
    print(f"{cell}: kernel path == plain path: count, ptrs, delays, bits "
          f"equal; peaks / chans / phasors within {errs[0]:.2e} / "
          f"{errs[1]:.2e} / {errs[2]:.2e}; both routes' scans == "
          f"track_scan_plain: every carry field's bits, accept, ptr, delay "
          f"equal, peaks and channel table within {err['warp']:.2e} (warp) / "
          f"{err['block']:.2e} (block)")

    # -- times ----------------------------------------------------------------
    call, rounds = call_ms(lambda: track(xs))
    launch = functools.partial(ktrk._launch, cfg=cfg, x=xs, x_start=0,
                               fire_limit=n, carry=carry0, steps=steps,
                               max_det=max_det)
    ms = {kind: event_ms(lambda: launch(kind), 5, evict=False)
          for kind in ("warp", "block")}
    # every step frozen from the first (fire_limit 0): the kernel's cost
    # besides its chain of fired steps
    frozen = event_ms(lambda: launch("warp", fire_limit=0), 5, evict=False)
    computed, nbytes, ops = tracker_work(cfg, xs, scan)
    bound_ms, bound_by = bound(nbytes, ops)
    chain = int(computed.max())
    per_step = (ms["warp"] - frozen) * 1e3 / (chain - 1)
    print(f"{cell}: track_frame {call:.3f} ms a call (median of rounds "
          f"{', '.join(f'{t:.3f}' for t in rounds)}), "
          f"{batch * n / call / 1e3:.3f} Msamples/s, {n / call / 1e3:.3f} a "
          f"stream; the step-loop kernel: warp route {ms['warp']:.4f} ms "
          f"({ms['warp'] * 1e3 / steps:.4f} us a step of {steps}, "
          f"{ms['warp'] * 1e3 / chain:.4f} us a computed step of {chain}), "
          f"block route {ms['block']:.4f} ms ({ms['block'] * 1e3 / steps:.4f} "
          f"us a step); warp route with every step frozen {frozen:.4f} ms, "
          f"so {per_step:.4f} us a fired step; plain loop eager "
          f"{plain_ms:.1f} ms; bound {bound_ms:.5f} ms by "
          f"{bound_by} ({nbytes} bytes, {ops:.3e} operations), {chain} "
          f"computed steps x one dependent load from the L2 "
          f"({load_ms * 1e6:.1f} ns) = {chain * load_ms:.4f} ms; on {gpu}")
    busy, launches = profile(lambda i: track(xs), f"{cell} track_frame")
    print(f"{cell}: track_frame busy {busy:.4f} ms of {call:.3f} a call "
          f"(idle share {1 - busy / call:.3f}), {launches:.1f} device "
          "launches a call")

    # -- the card-filling batch ----------------------------------------------
    big = torch.cuda.get_device_properties(dev).multi_processor_count * \
        TRACKER_FILL_PER_SM
    cell_b = f"{name} tracker b{big}"
    xb, bits_b = tracker_streams(cfg, big, snr_db, dev)
    track_b, _, counts_b = tracker_main_path(cfg, xb, bits_b, "warp", cell_b)
    carry_b = tracker.tracker_init_carry(big, dev)
    block_b = ktrk._launch("block", cfg, xb, 0, n, carry_b, steps, max_det)
    err_b = tracker_check(cfg, xb, steps, max_det, "warp", block_b, cell_b)
    call_b, rounds_b = call_ms(lambda: track_b(xb))
    ms_b = event_ms(lambda: ktrk._launch("warp", cfg, xb, 0, n, carry_b,
                                         steps, max_det), 5, evict=False)
    computed_b, nbytes_b, ops_b = tracker_work(cfg, xb, block_b)
    chain_b = int(computed_b.max())
    bound_b, bound_by_b = bound(nbytes_b, ops_b)
    print(f"{cell_b}: warp route == block route (every integer output and "
          f"carry bit; floats within {err_b:.2e}); track_frame {call_b:.3f} "
          f"ms a call (rounds {', '.join(f'{t:.3f}' for t in rounds_b)}), "
          f"{big * n / call_b / 1e3:.3f} Msamples/s, "
          f"{n / call_b / 1e3:.3f} a stream; the warp route {ms_b:.4f} ms "
          f"({ms_b * 1e3 / chain_b:.4f} us a computed step of {chain_b}); "
          f"bound {bound_b:.5f} ms by {bound_by_b}; on "
          f"{gpu}")

    k2 = tracker_k2(cfg, lambda: track(xs), cell)
    entry = tracker_entry("tracker_scan_warp", cell, counts["tracker"],
                          err["warp"], ms["warp"], plain_ms, bound_ms,
                          bound_by, steps, chain, load_ms)
    entry.update({
        "other_route_ms": ms["block"], "frozen_ms": frozen,
        "us_per_fired_step": per_step, "call_ms": call,
        "msps": batch * n / call / 1e3, "busy_ms": busy,
        "fill_batch": big, "fill_launches": counts_b["tracker"],
        "fill_ms": ms_b, "fill_call_ms": call_b,
        "fill_msps": big * n / call_b / 1e3,
        "fill_us_per_computed_step": ms_b * 1e3 / chain_b,
        "fill_bound_ms": bound_b})
    return [entry, kernel_entry("equalize", cell, counts["equalize"], k2)]


def tracker_entry(kernel, cell, launches, err, ms, plain_ms, bound_ms,
                  bound_by, steps, chain, load_ms) -> dict:
    """One tracker entry of the ``kernels`` line.  There is no library
    call: torch has no sequential scan."""
    return {"name": f"{kernel} [{cell}]", "route": "cuda",
            "source": SOURCES["tracker"][0],
            "replaces": SOURCES["tracker"][1], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "steps": steps, "computed_steps": chain,
            "us_per_step": ms * 1e3 / steps,
            "us_per_computed_step": ms * 1e3 / chain,
            "latency_bound_ms": chain * load_ms,
            "dependent_load_ns": load_ms * 1e6}


def tracker_k2(cfg, run, cell) -> dict:
    """K2 against its plain version on what the tracker path run() hands
    it (its one demod call: the detection table's windows and their
    coefficient rows)."""
    with kernel_inputs() as seen:
        run()
    return path_checks(cfg, seen, cell)["equalize"]


def real_time_msps(cfg) -> float:
    """One stream's sample rate: nfft bins at the bin spacing."""
    return cfg.nfft * cfg.bin_spacing / 1e6


def tracker_block_run(name, batch, snr_db, dev, gpu, load_ms) -> list:
    """The block route on its own main path: ``make_tracker`` on ``batch``
    buffers of config ``name`` (nfft above the warp route's limit) made on
    the card: one tracker launch on the block route and one K2 launch,
    every block detected with the sent bits, kernel path == plain path,
    the kernel's scan == the plain twin's; its time a call, a step and a
    computed step, Msamples/s against one stream's real-time rate; K2
    against its plain version at the demod shape.  Returns the ``kernels``
    entries (the tracker's and K2's)."""
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.models import tracker
    from lte_gnu_radio_code_tpu_torch.utils import params

    cfg = getattr(params, name)
    cell = f"{name} tracker b{batch}"
    max_det = cfg.num_patterns
    xs, bits = tracker_streams(cfg, batch, snr_db, dev)
    n = xs.shape[1]
    steps = int(np.ceil(n / tracker.tracker_stride(cfg))) + 1
    track, r, counts = tracker_main_path(cfg, xs, bits, "block", cell)
    scan, plain_ms, errs = tracker_plain(cfg, xs, steps, max_det, r, cell)
    err = tracker_check(cfg, xs, steps, max_det, "block", scan, cell)
    print(f"{cell}: kernel path == plain path (floats within "
          f"{max(errs):.2e}), the block route's scan == track_scan_plain "
          f"in every carry field's bits, accept, ptr, delay (floats within "
          f"{err:.2e})")
    return tracker_block_times(cfg, cell, xs, scan, track, steps, max_det,
                               counts, err, plain_ms, gpu, load_ms)


def tracker_block_times(cfg, cell, xs, scan, track, steps, max_det, counts,
                        err, plain_ms, gpu, load_ms) -> list:
    """The block route's times at one shape, printed: ``track_frame`` a
    call (median of three) and its Msamples/s, in all and a stream,
    against one stream's real-time rate; the kernel alone (CUDA events, L2
    warm) a call, a step and a computed step; the bound of what the data
    needs (``tracker_work``); a profile of three calls (busy, idle share,
    the largest device kernels); then K2 held to its plain version on what
    the call hands it.  Returns the tracker's and K2's ``kernels``
    entries, with the main run's launch counts."""
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.models import tracker

    batch, n = xs.shape
    call, rounds = call_ms(lambda: track(xs))
    carry0 = tracker.tracker_init_carry(batch, xs.device)
    ms = event_ms(lambda: ktrk._launch("block", cfg, xs, 0, n, carry0, steps,
                                       max_det), 5, evict=False)
    computed, nbytes, ops = tracker_work(cfg, xs, scan)
    bound_ms, bound_by = bound(nbytes, ops)
    chain = int(computed.max())
    msps = batch * n / call / 1e3
    print(f"{cell}: track_frame {call:.3f} ms a call (rounds "
          f"{', '.join(f'{t:.3f}' for t in rounds)}), {msps:.3f} Msamples/s, "
          f"{msps / batch:.3f} a stream against the real time of "
          f"{real_time_msps(cfg):.2f}; the block route {ms:.4f} ms, "
          f"{ms * 1e3 / steps:.4f} us a step of {steps}, "
          f"{ms * 1e3 / chain:.4f} us a computed step of {chain} "
          f"({int(computed.sum())} in all); plain loop eager "
          f"{plain_ms:.1f} ms; bound {bound_ms:.5f} ms by {bound_by} "
          f"({nbytes} bytes, {ops:.3e} operations), share "
          f"{bound_ms / ms:.5f}; {chain} dependent L2 loads "
          f"{chain * load_ms:.4f} ms; on {gpu}")
    busy, launches = profile(lambda i: track(xs), f"{cell} track_frame",
                             top=6)
    print(f"{cell}: track_frame busy {busy:.4f} ms of {call:.3f} a call "
          f"(idle share {1 - busy / call:.3f}), {launches:.1f} device "
          "launches a call")
    entry = tracker_entry("tracker_scan", cell, counts["tracker"], err, ms,
                          plain_ms, bound_ms, bound_by, steps, chain, load_ms)
    entry.update({"call_ms": call, "busy_ms": busy, "msps": msps,
                  "msps_per_stream": msps / batch,
                  "real_time_msps": real_time_msps(cfg)})
    k2 = tracker_k2(cfg, lambda: track(xs), cell)
    return [entry, kernel_entry("equalize", cell, counts["equalize"], k2)]


def tracker_fill_run(dev, gpu, load_ms) -> list:
    """The block route at the batch that fills the card: LTE1024 buffers,
    TRACKER_FILL_PER_SM streams (blocks of 256 threads) on each SM.  The
    main path's gates (one block-route and one K2 launch, every block
    detected with the sent bits), the first 4 streams == a call of
    ``make_tracker`` on those 4 rows alone, the kernel's scan == the plain
    twin's; the times and K2's gate of :func:`tracker_block_times`.
    Returns the ``kernels`` entries."""
    from lte_gnu_radio_code_tpu_torch.models import tracker
    from lte_gnu_radio_code_tpu_torch.utils import params

    name, _, snr_db = TRACKER_LTE[0]
    cfg = getattr(params, name)
    big = torch.cuda.get_device_properties(dev).multi_processor_count * \
        TRACKER_FILL_PER_SM
    cell = f"{name} tracker b{big}"
    max_det = cfg.num_patterns
    xs, bits = tracker_streams(cfg, big, snr_db, dev)
    n = xs.shape[1]
    steps = int(np.ceil(n / tracker.tracker_stride(cfg))) + 1
    track, r, counts = tracker_main_path(cfg, xs, bits, "block", cell)
    head = tracker.make_tracker(cfg, n)(xs[:4].contiguous())
    errs4 = same_track(tracker.TrackResult(*(f[:4] for f in r)), head,
                       f"{cell}: streams 0-3 vs a call on those 4 alone")
    scan, plain_ms, errs = tracker_plain(cfg, xs, steps, max_det, r, cell)
    err = tracker_check(cfg, xs, steps, max_det, "block", scan, cell)
    print(f"{cell}: {xs.nbytes / 1e6:.1f} MB of samples; streams 0-3 == a "
          f"call on those 4 alone (floats within {max(errs4):.2e}); kernel "
          f"path == plain path (floats within {max(errs):.2e}), the block "
          f"route's scan == track_scan_plain (floats within {err:.2e})")
    return tracker_block_times(cfg, cell, xs, scan, track, steps, max_det,
                               counts, err, plain_ms, gpu, load_ms)


def tracker_stream_run(name, frames, chunk_strides, gap_frame, dev, gpu,
                       load_ms) -> list:
    """``TrackerStreamingRx`` on one stream of ``frames`` frames of config
    ``name`` made on the card (K1, one Fading convolution over the stream,
    AWGN at 100 dB), with TRACKER_GAP zero samples inserted 37 samples
    into frame ``gap_frame`` (None: no gap), pushed in chunks of
    ``chunk_strides`` strides: one tracker launch on the route the rule
    names and one K2 launch a step, chunked == ``track_frame`` on the
    whole buffer, ``push_many`` == pushes, every detection before the gap
    (before the last block without one) one pattern block after the one
    before and its bits == the sent bits, no host synchronisation in a
    chunk step; its Msamples/s; the tracker kernel and K2 held to their
    plain versions on a chunk step's inputs (:func:`tracker_stream_kernels`).
    The detections after the gap are printed, not gated: the tracker
    re-adjusts there as the reference does.  Returns the ``kernels``
    entries."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.models import tracker
    from lte_gnu_radio_code_tpu_torch.runtime import stream as rt
    from lte_gnu_radio_code_tpu_torch.utils import params

    cfg = getattr(params, name)
    kind = ktrk.route(cfg)
    cell = f"{name} tracker stream ({frames} frames)"
    stream, bits = make_streams(cfg, 1, frames * cfg.frame_len, dev)
    block = cfg.pattern_len * cfg.rx_b_len
    x = stream[0]
    if gap_frame is not None:
        gap_at = gap_frame * cfg.frame_len + 37
        x = torch.cat([x[:gap_at],
                       torch.zeros(TRACKER_GAP, dtype=x.dtype, device=dev),
                       x[gap_at:]])
    chunk = chunk_strides * tracker.tracker_stride(cfg)
    k = len(x) // chunk
    chunks = x[:k * chunk].reshape(k, chunk)
    n_real = k * chunk

    rx = rt.TrackerStreamingRx(cfg, chunk)
    rx.push(chunks[0])                                  # warm-up, discarded
    rx = rt.TrackerStreamingRx(cfg, chunk)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    many = rx.push_many(chunks)
    outs = cat_outs([many, stack_outs(rx.finish())])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    routes = dict(ktrk.route_launches)
    steps = outs.valid.shape[0]
    want = {**dict.fromkeys(kernels.KERNEL_MODULES, 0), "tracker": steps,
            "equalize": steps}
    if counts != want or routes[kind] != steps or sum(routes.values()) != steps:
        raise AssertionError(f"{cell}: {steps} chunk steps, launches "
                             f"{counts} (expected {want}), tracker routes "
                             f"{routes} (expected {kind})")
    v = outs.valid.reshape(-1)
    got = {f: getattr(outs, f).reshape(len(v), -1)[v]
           for f in ("ptrs", "delays", "hard_bits")}
    whole = tracker.make_tracker(cfg, n_real,
                                 max_det=n_real // block + 2)(x[:n_real])
    nb = int(whole.count)
    nd_bits = cfg.synch_dat[1] * cfg.num_data_bins * 2
    if len(got["ptrs"]) != nb or not torch.equal(
            got["ptrs"][:, 0], whole.ptrs[:nb]) or not torch.equal(
            got["delays"][:, 0], whole.delays[:nb]) or not torch.equal(
            got["hard_bits"].reshape(-1), whole.hard_bits[:nb * nd_bits]):
        raise AssertionError(f"{cell}: chunk by chunk ({len(got['ptrs'])} "
                             f"detections) vs track_frame on the whole "
                             f"buffer ({nb})")
    before = (gap_at if gap_frame is not None else n_real) // block - 1
    sent = bits.reshape(-1)[:before * nd_bits]
    wrong = int((whole.hard_bits[:before * nd_bits] != sent).sum())
    step = torch.diff((whole.ptrs + whole.delays)[:nb])
    off = torch.nonzero(step != block).reshape(-1).tolist()
    if wrong or nb < before or (off and off[0] < before - 1):
        raise AssertionError(f"{cell}: {nb} detections, the first off the "
                             f"block cadence after detection {off[:1]}, "
                             f"{wrong} of the bits of the first {before} "
                             f"blocks differ from the sent bits")
    srx = rt.TrackerStreamingRx(cfg, chunk)
    same_outs(stack_outs([srx.push(c) for c in chunks]), many,
              f"{cell}: pushes vs push_many")
    torch.cuda.set_sync_debug_mode("error")
    try:
        srx.push(chunks[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    times = []
    for _ in range(SERVING_ROUNDS):
        trx = rt.TrackerStreamingRx(cfg, chunk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trx.push_many(chunks)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    print(f"{cell}: {k} chunks of {chunk} (+ {steps - k} flush), {rx.slots} "
          f"steps a chunk, launches {counts}, tracker route {kind}; chunked "
          f"== track_frame on the whole buffer ({nb} detections, the first "
          f"off the block cadence after detection {off[:2]}), push_many == "
          f"pushes, the first {before} detections on cadence and their "
          f"{before * nd_bits} bits == the sent bits, a chunk step ran under "
          f"sync debug mode \"error\"; {n_real / dt / 1e6:.3f} Msamples/s "
          f"against the real time of {real_time_msps(cfg):.2f}, "
          f"{dt * 1e3 / k:.3f} ms a chunk step (rounds "
          f"{', '.join(f'{t * 1e3 / k:.3f}' for t in times)}) on {gpu}")
    return tracker_stream_kernels(
        cfg, kind, lambda: rt.TrackerStreamingRx(cfg, chunk), chunks, counts,
        cell, load_ms)


def tracker_stream_kernels(cfg, kind, make, chunks, counts, cell,
                           load_ms) -> list:
    """The tracker kernel of route ``kind`` and K2 against their plain
    versions on what the second chunk step of a fresh receiver make()
    hands them (the stream's x_start and fire_limit, the first step's
    carry): the scan == ``track_scan_plain``'s (:func:`tracker_check`), K2
    within its tolerance; the kernel's time (CUDA events, L2 warm), the
    plain loop's (one eager call) and the bound of what the data needs.
    Returns both ``kernels`` entries, with the main run's launch counts."""
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk

    with kernel_inputs() as seen:
        make().push_many(chunks[:2])
    x, x_start, limit, carry, steps, max_det = seen["tracker"][1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ktrk.track_scan_plain(cfg, x, x_start, limit, carry, steps, max_det)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = tracker_check(cfg, x, steps, max_det, kind, ref, cell, x_start,
                        limit, carry)
    ms = event_ms(lambda: ktrk._launch(kind, cfg, x, x_start, limit, carry,
                                       steps, max_det), 5, evict=False)
    computed, nbytes, ops = tracker_work(cfg, x, ref, x_start, carry)
    bound_ms, bound_by = bound(nbytes, ops)
    chain = int(computed.max())
    print(f"{cell}: chunk step 2's scan ({steps} steps over {x.shape[1]} "
          f"samples, {chain} computed): the {kind} route == track_scan_plain "
          f"(floats within {err:.2e}); {ms:.4f} ms, plain loop eager "
          f"{plain_ms:.1f} ms, bound {bound_ms:.5f} ms by {bound_by}")
    k2 = path_checks(cfg, seen, cell, step=1)["equalize"]
    name = "tracker_scan_warp" if kind == "warp" else "tracker_scan"
    return [tracker_entry(name, cell, counts["tracker"], err, ms, plain_ms,
                          bound_ms, bound_by, steps, chain, load_ms),
            kernel_entry("equalize", cell, counts["equalize"], k2)]


def tracker_cell_run(dev, gpu, load_ms) -> list:
    """``BatchTrackerStreamingRx`` at the l1k-track cell's shape
    (TRACKER_CELL): 16 continuous 10 MHz LTE streams made on the card,
    pushed in chunks of 131,072: one tracker and one K2 launch a chunk step
    on the block route, every detection one pattern block after the one
    before it in its stream, the first steps' bits == the sent bits; then
    on the next chunk step's inputs (a tracking carry) the kernel ==
    ``track_scan_plain`` (:func:`tracker_check`), its time from a cold and
    a warm L2, the chunk step's (push, median of three), the bound of
    what the data needs (``tracker_work``) and K2 against its plain
    version.  Returns both ``kernels`` entries."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.runtime import stream as rt
    from lte_gnu_radio_code_tpu_torch.utils import params

    changes, batch, chunk, k = TRACKER_CELL
    cfg = config_of("LTE1024", changes)
    cell = f"l1k-track tracker stream b{batch}"
    streams, bits = make_streams(cfg, batch, (k + 1) * chunk, dev)
    chunks = streams.reshape(batch, k + 1, chunk).transpose(0, 1).contiguous()
    rx = rt.BatchTrackerStreamingRx(cfg, chunk, batch)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs = stack_outs([rx.push(c) for c in chunks[:k]])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {**dict.fromkeys(kernels.KERNEL_MODULES, 0), "tracker": k,
            "equalize": k}
    if counts != want or ktrk.route(cfg) != "block":
        raise AssertionError(f"{cell}: launches {counts}, expected {want}")
    block = cfg.pattern_len * cfg.rx_b_len
    nd_bits = cfg.synch_dat[1] * cfg.num_data_bins * 2
    found = 0
    for b in range(batch):
        v = outs.valid[:, b].reshape(-1)
        bound_ = (outs.ptrs + outs.delays)[:, b].reshape(-1)[v]
        steps_ = torch.diff(bound_)
        hard = outs.hard_bits[:, b].reshape(len(v), -1)[v].reshape(-1)
        sent = bits[b].reshape(-1)[:len(hard)]
        if (steps_ != block).any() or not torch.equal(hard[:len(sent)], sent):
            raise AssertionError(f"{cell}: stream {b}: {len(bound_)} "
                                 "detections, off the block grid or bits "
                                 "that differ from the sent ones")
        found += len(bound_)
    with kernel_inputs() as seen:
        state = rx.state
        rx.push(chunks[k])
    x, x_start, limit, carry, steps, max_det = seen["tracker"][0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ktrk.track_scan_plain(cfg, x, x_start, limit, carry, steps, max_det)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = tracker_check(cfg, x, steps, max_det, "block", ref, cell, x_start,
                        limit, carry)
    run = lambda: ktrk._launch("block", cfg, x, x_start, limit, carry, steps,
                               max_det)
    cold = event_ms(run, 5)
    ms = event_ms(run, 5, evict=False)
    computed, nbytes, ops = tracker_work(cfg, x, ref, x_start, carry)
    bound_ms, bound_by = bound(nbytes, ops)
    chain = int(computed.max())

    def push():
        rx.state = state
        rx.push(chunks[k])

    step_ms, rounds = call_ms(push)
    print(f"{cell}: {k} chunk steps, launches {counts}, {found} detections "
          f"on the block grid with the sent bits; chunk step {k}'s scan "
          f"({steps} steps over {x.shape[1]} samples a stream, {chain} "
          f"computed by the slowest stream, {int(computed.sum())} in all) "
          f"== track_scan_plain (floats within {err:.2e}); the block route "
          f"{cold:.4f} ms from a cold L2, {ms:.4f} warm, "
          f"{ms * 1e3 / chain:.3f} us a computed step; plain loop eager "
          f"{plain_ms:.1f} ms; bound {bound_ms:.5f} ms by {bound_by} "
          f"({nbytes} bytes, {ops:.3e} operations), share "
          f"{bound_ms / cold:.5f}; {chain} dependent L2 loads "
          f"{chain * load_ms:.4f} ms; the chunk step (push) {step_ms:.3f} ms "
          f"(rounds {', '.join(f'{t:.3f}' for t in rounds)}) on {gpu}")
    k2 = path_checks(cfg, seen, cell)["equalize"]
    entry = tracker_entry("tracker_scan", cell, counts["tracker"], err, cold,
                          plain_ms, bound_ms, bound_by, steps, chain, load_ms)
    entry.update({"warm_ms": ms, "step_ms": step_ms})
    return [entry, kernel_entry("equalize", cell, counts["equalize"], k2)]


def file_check(dev) -> None:
    """The file CLIs as a user calls them, with no --device: tx_file
    --generate writes a frame; faded, it goes through ofdm_chain
    --tx-pickle / --bits-pickle and --stream with the loopback's lock,
    delay and BER; rx_file --case 7 --stream on a capture made on the card
    finds what the whole-buffer receiver finds."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.cli import ofdm_chain, rx_file, tx_file
    from lte_gnu_radio_code_tpu_torch.io import pickles
    from lte_gnu_radio_code_tpu_torch.models import chain
    from lte_gnu_radio_code_tpu_torch.utils import params

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        kernels.reset_launch_counts()
        gen = tx_file.main([str(tmp / "tx.pckl"), "--generate", "--json"])
        cfg = params.config_from_profile(params.SDR_PROFILES[0])
        tx = pickles.load_pickle_iq(tmp / "tx.pckl").ravel()
        faded = np.convolve(tx, chain.loopback_taps(cfg))
        pickles.save_pickle_iq(tmp / "rx.pckl", faded[None])
        pickles.save_pickle_iq(tmp / "bits.pckl", np.random.default_rng(
            0).integers(0, 2, cfg.num_bits, dtype=np.int32)[None])
        files = ["--tx-pickle", str(tmp / "rx.pckl"), "--bits-pickle",
                 str(tmp / "bits.pckl"), "--json"]
        one = ofdm_chain.main(files)
        streamed = ofdm_chain.main(files + ["--stream", "960", "--repeat",
                                            "2"])
        counts = kernels.launch_counts()
        want = {"found": True, "lock_ptr": 16, "delay_idx": 1, "ber": 0.0}
        if (gen["samples"] != cfg.frame_len or one != want or
                streamed["detections"] != 2 * cfg.num_patterns or
                streamed["ber"] != 0.0 or counts["ofdm_mod"] != 1 or
                counts["sync_search"] < 2 or counts["equalize"] < 2):
            raise AssertionError(f"file CLIs: tx_file {gen}, ofdm_chain "
                                 f"--tx-pickle {one} (expected {want}), "
                                 f"--stream {streamed}, launches {counts}")
        print(f"tx_file --generate -> {gen['samples']} samples; "
              f"ofdm_chain --tx-pickle {one}; --stream 960 --repeat 2 "
              f"{streamed}; launches {counts}")

        c7 = params.config_from_case(params.CFO_CASES, 7)
        x, _ = make_streams(c7, 1, 8 * c7.frame_len, dev)
        pickles.save_pickle_iq(tmp / "c7.pckl", x.cpu().numpy())
        whole = rx_file.main([str(tmp / "c7.pckl"), "--case", "7", "--json",
                              "--max-det", "1000"])
        streamed = rx_file.main([str(tmp / "c7.pckl"), "--case", "7",
                                 "--stream", str(2048 * c7.stride),
                                 "--json", "--max-det", "1000"])
        blocks = 8 * c7.num_patterns
        if streamed != whole or whole["detections"] < blocks - 1:
            raise AssertionError(f"rx_file --case 7: whole buffer "
                                 f"{whole['detections']} detections, "
                                 f"--stream {streamed['detections']} (of "
                                 f"{blocks} blocks)")
        print(f"rx_file --case 7 on a capture of {blocks} blocks made on the "
              f"card: {whole['detections']} detections, --stream == whole "
              "buffer")


def split_check(dev) -> None:
    """The split RX on the card by default: stage A (K4) and stage B (K2)
    on one GOLDEN64 frame give the monolithic rx_frame's lock, delay and
    bits exactly, with one launch of each kernel."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.models import (chain, rxofdm, split,
                                                     txofdm)
    from lte_gnu_radio_code_tpu_torch.ops import channel
    from lte_gnu_radio_code_tpu_torch.utils.params import GOLDEN64 as cfg

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    bits = torch.randint(0, 2, (1, cfg.num_bits), generator=gen, device=dev,
                         dtype=torch.int32)
    tx = txofdm.tx_frames(cfg, bits)
    x = channel.apply_channel(tx, chain.loopback_taps(cfg), cfg.nfft)[0]
    find, demod = split.make_split_rx(cfg, len(x))
    kernels.reset_launch_counts()
    a = find(x)
    b = demod(a.passthrough, a.ptrs[0], a.delays[0])
    counts = kernels.launch_counts()
    mono = rxofdm.make_rx(cfg, len(x))(x)
    if (counts != {**dict.fromkeys(kernels.KERNEL_MODULES, 0),
                   "sync_search": 1, "equalize": 1} or
            int(a.count) != cfg.num_patterns or
            int(a.ptrs[0]) != int(mono.lock_ptr) or
            int(a.delays[0]) != int(mono.delay_idx) or
            not torch.equal(b.hard_bits, mono.hard_bits) or
            not torch.equal(b.hard_bits, bits[0])):
        raise AssertionError(
            f"split RX: launches {counts}, {int(a.count)} detections, lock "
            f"{int(a.ptrs[0])}/{int(mono.lock_ptr)}, delay "
            f"{int(a.delays[0])}/{int(mono.delay_idx)}, "
            f"{int((b.hard_bits != mono.hard_bits).sum())} bits differ from "
            "rx_frame's")
    print(f"split RX on the card: find_synch_index + channel_estimate_demod "
          f"== rx_frame: lock {int(a.ptrs[0])}, delay {int(a.delays[0])}, "
          f"{int(a.count)} detections, bits equal and == the sent bits; "
          f"launches {counts}")


def cli_check(dev) -> None:
    """The loopback entry point as a user calls it, with no --device: one
    GOLDEN64 frame through the four kernels on the card."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.cli import ofdm_chain

    kernels.reset_launch_counts()
    out = ofdm_chain.main(["--json"])
    counts = kernels.launch_counts()
    want = {"found": True, "lock_ptr": 16, "delay_idx": 1, "ber": 0.0}
    if out != want or counts != {**dict.fromkeys(kernels.KERNEL_MODULES, 1),
                                 "tracker": 0, "mimo_detect": 0}:
        raise AssertionError(f"cli.ofdm_chain: {out} (expected {want}), "
                             f"launches {counts}")
    print(f"cli.ofdm_chain on the card: {out}, launches {counts}")

    from lte_gnu_radio_code_tpu_torch.cli import ber_sweep
    kernels.reset_launch_counts()
    out = ofdm_chain.main(["--json", "--config",
                           str(REPO / "configs/tx16qam.json")])
    rows = ber_sweep.main(["--json", "--config",
                           str(REPO / "configs/qam64_sweep.json"),
                           "--snrs", "12", "100", "--frames", "4"])
    counts = kernels.launch_counts()
    want = {"found": True, "lock_ptr": 16, "delay_idx": 0, "ber": 0.0}
    if (out != want or
            counts != {**dict.fromkeys(kernels.KERNEL_MODULES, 3),
                       "tracker": 0, "mimo_detect": 0} or
            not 0.01 < rows[0]["ber"] < 0.3 or rows[1]["ber"] != 0.0):
        raise AssertionError(f"cli.ofdm_chain on tx16qam.json: {out} "
                             f"(expected {want}); cli.ber_sweep: {rows}; "
                             f"launches {counts}")
    print(f"cli.ofdm_chain --config configs/tx16qam.json on the card: {out}; "
          f"cli.ber_sweep --config configs/qam64_sweep.json: {rows}; "
          f"launches {counts}")
    file_check(dev)


def mimo_config(sdr_profile):
    """A MIMO cell's configuration at 100 dB and its own SNR: the test
    configuration (None), the benchmark's "lte2048_2x2" at 12 dB, or an SDR
    profile's, by its index."""
    import dataclasses
    from lte_gnu_radio_code_tpu_torch.utils import params
    if sdr_profile is None:
        own = params.OFDMConfig(synch_dat=(2, 2), num_ofdm_symb=48,
                                num_ant_txrx=2, snr_db=100.0).validate()
    elif sdr_profile == "lte2048_2x2":
        own = dataclasses.replace(params.LTE2048, synch_dat=(2, 6),
                                  num_ant_txrx=2, snr_db=12.0).validate()
    else:
        own = dataclasses.replace(params.config_from_profile(
            params.SDR_PROFILES[sdr_profile]), synch_dat=(2, 2)).validate()
    return dataclasses.replace(own, snr_db=100.0).validate(), own


def mimo_run(name, sdr_profile, batch, dev, gpu) -> list:
    """Both 2x2 modes at one configuration (module docstring): the chain as
    a user builds it (``make_mimo_chain`` / ``make_stcode_chain``, on the
    card), timed over rounds of CHAIN_REPS steps; every frame locked with
    BER 0, one K4 launch a step on the direct route and no other kernel,
    kernel path == plain path (CPU copies) on one noise tensor, no host
    synchronisation in a step; at the configuration's own SNR kernel and
    plain paths within 1e-4 of the bits; K4 against its plain versions at
    the step's search shape (ZC slice 0).  A SpMult step also launches the
    detection's two kernels.  The K4 route is the rule's at
    the search view's shape (direct at nfft 64, FFT at LTE widths).
    Returns the cells' entries of the kernels line."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.kernels import sync_search
    from lte_gnu_radio_code_tpu_torch.models import mimo
    from lte_gnu_radio_code_tpu_torch.ops import channel

    cfg, own = mimo_config(sdr_profile)
    n = cfg.frame_len + cfg.nfft - 1
    n_trials, _ = mimo.plan(cfg, n)
    view = mimo.search_config(cfg)
    kind = sync_search.route(view.nfft, view.cp_len, view.stride,
                             view.m_synch)
    h = torch.as_tensor(channel.mimo2_taps("Fading"), device=dev)
    entries = []
    for mode, make, tx in (("SpMult", mimo.make_mimo_chain,
                            mimo.tx_frame_mimo),
                           ("STCode", mimo.make_stcode_chain,
                            mimo.tx_frame_stcode)):
        cell = f"{name} {mode} b{batch}"
        shape = (batch, 2) if mode == "SpMult" else (batch,)
        rng = np.random.default_rng(SEED + 7)
        bits = torch.as_tensor(rng.integers(0, 2, (*shape, cfg.num_bits),
                                            dtype=np.int32), device=dev)
        step = make(cfg)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        step(bits, generator=gen)                       # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(CHAIN_ROUNDS):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            results = [step(bits ^ (i & 1), generator=gen)
                       for i in range(CHAIN_REPS)]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        dt = sorted(times)[len(times) // 2]
        counts = kernels.launch_counts()
        routes = dict(sync_search.route_launches)
        found = torch.stack([r.found for r in results])
        ber = torch.stack([r.ber for r in results])
        locks = torch.stack([r.lock_ptr for r in results]).unique().tolist()
        detects = 2 * CHAIN_REPS * (mode == "SpMult")
        if (counts != {**dict.fromkeys(kernels.KERNEL_MODULES, 0),
                       "sync_search": CHAIN_REPS, "mimo_detect": detects} or
                routes != {r: CHAIN_REPS * (r == kind) for r in routes} or
                sync_search.peak_launches != routes):
            raise AssertionError(f"{cell}: launches {counts}, sync_search by "
                                 f"route {routes}, in the peaks form "
                                 f"{sync_search.peak_launches} over "
                                 f"{CHAIN_REPS} steps, expected one {kind} "
                                 "K4 launch a step in the peaks form (and "
                                 "two of the detection a SpMult step)")
        if not bool(found.all()) or float(ber.max()) != 0.0:
            raise AssertionError(f"{cell}: {int((~found).sum())} frames "
                                 f"unlocked, worst BER {float(ber.max())}")

        noise = torch.complex(torch.randn(batch, 2, n, generator=gen,
                                          device=dev),
                              torch.randn(batch, 2, n, generator=gen,
                                          device=dev))
        rk = step(bits, noise=noise)
        rp = moved(make(cfg, device="cpu")(bits.cpu(), noise=noise.cpu()),
                   dev)
        for f in ("found", "lock_ptr", "delay_idx", "hard_bits"):
            if not torch.equal(getattr(rk, f), getattr(rp, f)):
                raise AssertionError(f"{cell}: kernel vs plain path: {f} "
                                     "differs")
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(bits, generator=gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        step_ms = dt * 1e3 / CHAIN_REPS
        msps = CHAIN_REPS * batch * 2 * n / dt / 1e6
        rounds = ", ".join(f"{t * 1e3 / CHAIN_REPS:.3f}" for t in times)
        print(f"{cell}: {CHAIN_REPS} steps of {batch} frames x 2 antennas x "
              f"{n} samples: {step_ms:.3f} ms a step (median of rounds "
              f"{rounds}), {msps:.3f} Msamples/s (both RX antennas) on "
              f"{gpu}; all frames locked (lock_ptr {locks}), BER 0; "
              f"launches {counts}, sync_search by route {routes}; kernel "
              "path == plain path in found, lock, delay and bits; a step "
              "under torch's sync debug mode \"error\"")
        busy, launches = profile(lambda i: step(bits, generator=gen), cell)
        print(f"{cell}: device busy {busy:.3f} of {step_ms:.3f} ms a step: "
              f"idle share {1 - busy / step_ms:.3f}; {launches:.1f} device "
              "launches a step")

        if own.snr_db != cfg.snr_db:
            rk = make(own)(bits, noise=noise)
            rp = moved(make(own, device="cpu")(bits.cpu(),
                                               noise=noise.cpu()), dev)
            differ = float((rk.hard_bits != rp.hard_bits).float().mean())
            if (not bool(rk.found.all()) or not bool(rp.found.all()) or
                    differ > 1e-4):
                raise AssertionError(f"{cell} at {own.snr_db} dB: "
                                     f"{int((~rk.found).sum())} frames "
                                     f"unlocked, {differ} of the bits "
                                     "differ between kernel and plain paths")
            print(f"{cell} at {own.snr_db} dB: all frames locked, BER "
                  f"{float(rk.ber.mean()):.3e} (kernel) "
                  f"{float(rp.ber.mean()):.3e} (plain) on one noise; "
                  f"{differ:.2e} of the bits differ (allowed 1e-4)")

        sig = tx(cfg, bits)
        clean = channel.apply_channel_mimo(sig, h, max_impulse=cfg.nfft)
        y = channel.awgn(cfg, clean, (sig.abs() ** 2).mean((-2, -1))[
            ..., None, None], generator=gen)
        c = sync_checks(mimo.search_config(cfg), batch,
                        y[:, 0].contiguous(), n_trials, cell,
                        zc=mimo._search_zc(cfg))
        print_kernel_rows(cell, {"sync_search": c})
        entries.append(kernel_entry("sync_search", cell,
                                    counts["sync_search"], c))
        if mode == "SpMult" and sdr_profile in DETECT_BATCH:
            entries += detect_run(name, sdr_profile,
                                  DETECT_BATCH[sdr_profile], dev, gpu,
                                  counts["mimo_detect"] // CHAIN_REPS)
    return entries


def detect_run(name, sdr_profile, batch, dev, gpu, launches) -> list:
    """The SpMult detection's kernel pair at a 2x2 cell's step shape, on
    what ``rx_frame_mimo`` hands it (seeded frames through TX, the 2x2
    Fading channel and AWGN at the configuration's own SNR, then
    ``mimo._front``; every frame locked): against its twin within 1e-5,
    timed from a cold L2 beside the twin and the library call, the old
    body's broadcast ``torch.matmul`` of W with every data symbol (cuBLAS's
    batched gemv).  Bytes and operations as ``ofdm_bench/metrics/
    detect_roofline.py`` counts them: the data bins and H on them read
    once, both layers written once; 80 operations a bin, 40 a symbol-bin.
    ``launches``: the pair's launches a step that ``mimo_run`` counted on
    the main path.  Returns the cell's entry of the kernels line."""
    from lte_gnu_radio_code_tpu_torch.kernels import mimo_detect
    from lte_gnu_radio_code_tpu_torch.models import mimo
    from lte_gnu_radio_code_tpu_torch.ops import channel, sync

    _, cfg = mimo_config(sdr_profile)
    n = cfg.frame_len + cfg.nfft - 1
    n_trials, num_patterns = mimo.plan(cfg, n)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    bits = torch.randint(0, 2, (batch, 2, cfg.num_bits), generator=gen,
                         device=dev, dtype=torch.int32)
    sig = mimo.tx_frame_mimo(cfg, bits)
    clean = channel.apply_channel_mimo(sig, torch.as_tensor(
        channel.mimo2_taps("Fading"), device=dev), max_impulse=cfg.nfft)
    y = channel.awgn(cfg, clean, (sig.abs() ** 2).mean((-2, -1))[
        ..., None, None], generator=gen)
    _, _, found, chan, fd = mimo._front(cfg, y, n_trials, num_patterns)
    cell = f"{name} detection b{batch}"
    if not bool(found.all()):
        raise AssertionError(f"{cell}: {int((~found).sum())} frames unlocked")
    bins = sync._bins_on(dev, cfg.nfft, cfg.num_data_bins)
    inv_snr = 1.0 / cfg.snr_linear
    kn, nb = fd.shape[-2:]
    hd = chan[..., bins].movedim(-1, -3)
    hh = hd.conj().transpose(-1, -2)
    w = mimo_detect.inv2x2(hh @ hd + inv_snr * torch.eye(
        2, dtype=hd.dtype, device=dev)) @ hh
    yv = fd.movedim(-3, -1)[..., None]
    c = compare(cell, lambda: mimo_detect.detect(fd, chan, bins, inv_snr),
                lambda: mimo_detect.detect_plain(fd, chan, bins, inv_snr),
                (fd, chan[..., bins]), batch * nb * (80 + 40 * kn),
                lambda: w[..., None, :, :, :] @ yv, atol=1e-5)
    print(f"{cell} [{batch}, 2, {kn}, {nb}] at {cfg.snr_db} dB on {gpu}:")
    print_kernel_rows(cell, {"mimo_detect": c})
    return [kernel_entry("mimo_detect", cell, launches, c)]


def pls_channels():
    """(name, h [2, 2, taps], the lock the search must find): the flat 2x2
    and the reference's 2x2 Fading, each delayed by PLS_DELAY
    (tests/test_pls.py).  Through the Fading taps the strongest arrival,
    |tap| summed over the four pairs after each pair's normalisation, is
    the one the lock finds."""
    flat = np.zeros((2, 2, PLS_DELAY + 1), complex)
    flat[:, :, PLS_DELAY] = [[1.0 + 0.2j, 0.45j], [0.3 - 0.1j, 0.9 + 0.3j]]
    taps = max(len(t) for row in MIMO2_FADING for t in row)
    fading = np.zeros((2, 2, PLS_DELAY + taps), complex)
    for r in range(2):
        for t in range(2):
            f = np.asarray(MIMO2_FADING[r][t])
            fading[r, t, PLS_DELAY:PLS_DELAY + len(f)] = f
    strongest = np.argmax(np.sum(np.abs(fading) / np.linalg.norm(
        fading, axis=-1, keepdims=True), axis=(0, 1)))
    return (("flat", flat, PLS_DELAY),
            ("Fading", fading, int(strongest)))


def pls_run(dev, gpu) -> None:
    """``key_exchange_synced`` on PLSConfig(), PLS_BATCH exchanges a call,
    each with its own key bits, over the delayed channels: noise-free every
    exchange recovers its key, with AWGN at PLS_SNR_DB at most 1 % of the
    key bits are wrong, and Bob's and Alice's locks are the expected ones
    in every exchange; times of a call (median of PLS_ROUNDS), exchanges
    and samples a second, busy and idle share, launches."""
    from lte_gnu_radio_code_tpu_torch.models import pls
    from lte_gnu_radio_code_tpu_torch.utils.params import PLSConfig

    cfg = PLSConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    keys = torch.randint(0, 2, (PLS_BATCH, cfg.pvt_info_len), generator=gen,
                         device=dev, dtype=torch.int32)
    ext = cfg.frame_len + PLS_MAX_DELAY
    for name, h, want in pls_channels():
        for snr in (None, PLS_SNR_DB):
            cell = (f"PLS {name} delay {PLS_DELAY}, "
                    f"{'noise-free' if snr is None else f'{snr} dB'}, "
                    f"b{PLS_BATCH}")

            def call(i=0):
                return pls.key_exchange_synced(cfg, keys, gen, h, snr,
                                               PLS_MAX_DELAY)
            call()
            torch.cuda.synchronize()
            times = []
            for _ in range(PLS_ROUNDS):
                t0 = time.perf_counter()
                bits, err, (pb, pa) = call()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            dt = sorted(times)[len(times) // 2]
            n_err = int(err.sum())
            if (bits.device.type != dev.type or
                    not bool((pb == want).all()) or
                    not bool((pa == want).all()) or
                    n_err > (0 if snr is None else 0.01 * keys.numel())):
                raise AssertionError(f"{cell}: {n_err} key bits wrong in "
                                     f"{int((err > 0).sum())} exchanges; "
                                     f"locks {pb.unique().tolist()} / "
                                     f"{pa.unique().tolist()}, expected "
                                     f"{want}")
            samples = PLS_BATCH * 2 * cfg.num_ant * ext      # two hops
            print(f"{cell}: {n_err} key bits wrong, locks Bob "
                  f"{pb.unique().tolist()} Alice {pa.unique().tolist()} "
                  f"(expected {want}); {dt * 1e3:.3f} ms a call (rounds "
                  f"{', '.join(f'{t * 1e3:.3f}' for t in times)}), "
                  f"{PLS_BATCH / dt:.1f} exchanges/s, "
                  f"{samples / dt / 1e6:.3f} Msamples/s through the two "
                  f"hops, on {gpu}")
            if name == "flat" and snr is None:
                busy, launches = profile(call, cell)
                print(f"{cell}: device busy {busy:.3f} of {dt * 1e3:.3f} ms "
                      f"a call: idle share {1 - busy / (dt * 1e3):.3f}; "
                      f"{launches:.1f} device launches a call")


def host_cpu() -> str:
    """The host's CPU as /proc/cpuinfo names it (vendor, model name, family
    and model numbers), its architecture and its logical CPUs."""
    info = {}
    with contextlib.suppress(OSError):
        for line in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    return (f"{info.get('vendor_id', '?')} {info.get('model name', '?')} "
            f"(family {info.get('cpu family', '?')}, model "
            f"{info.get('model', '?')}, {platform.machine()}), "
            f"{os.cpu_count()} logical CPUs")


def oracle_launches(dev, cell, want) -> dict:
    """The launch counts since the last reset: ``want`` on a CUDA device
    (every kernel of the path that fed the oracle), none on the CPU."""
    from lte_gnu_radio_code_tpu_torch import kernels
    counts = kernels.launch_counts()
    expect = {**dict.fromkeys(kernels.KERNEL_MODULES, 0),
              **(want if dev.type == "cuda" else {})}
    if counts != expect:
        raise AssertionError(f"{cell}: launches {counts}, expected {expect}")
    return counts


def worst_excess(got, want, rtol=0.0) -> float:
    """max |got - want| - rtol |want| (numpy), 0 for empty arrays."""
    d = np.abs(np.asarray(got) - np.asarray(want)) - rtol * np.abs(want)
    return float(d.max()) if d.size else 0.0


def oracle_chain(cfg, batch, frames, dev, cell) -> float:
    """One chain cell against the oracles (``reference_cpu/golden.py``,
    ``qam.py`` for QAM) on the same buffers: ``chain.transmit`` on the
    device (K1, K3 and AWGN at the config's own SNR, as
    ``noisy_chain_check`` draws them) gives the received samples, and
    ``chain_batch`` on the same bits and noise (on a CUDA device one
    replay of its graph, which runs the same TX) the RX outputs, over
    ``batch`` frames; K1 once more on the first ``frames`` frames' bits,
    then the oracle RX on each of those frames' received samples.
    Gates: TX rows within K1's 2e-5; lock pointer, delay and found equal;
    QPSK hard bits equal but in a symbol whose oracle phasor lies within
    2e-4 (K2's tolerance) of a decision boundary
    (``tests/torch_parity.py``), QAM hard bits equal, and the device's
    ``maxlog_llr`` on its phasors within 2e-3 + 2e-3 |llr| of the float64
    oracle's on the same phasors (``tests/test_qam_oracle.py``).  Returns
    the check's host seconds."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.models import chain, rxofdm, txofdm
    from lte_gnu_radio_code_tpu_torch.ops import modulation
    from lte_gnu_radio_code_tpu_torch.reference_cpu import golden, qam

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 5)
    bits = torch.as_tensor(rng.integers(0, 2, (batch, cfg.num_bits),
                                        dtype=np.int32), device=dev)
    n_samples = cfg.frame_len + cfg.nfft - 1
    n_trials, num_patterns = rxofdm.plan_rx(cfg, n_samples)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    noise = torch.complex(
        torch.randn(batch, n_samples, generator=gen, device=dev),
        torch.randn(batch, n_samples, generator=gen, device=dev))
    is_qam = cfg.modulation not in ("BPSK", "QPSK")
    h = chain.loopback_taps(cfg)
    kernels.reset_launch_counts()
    rxs = chain.transmit(cfg, h, bits, noise=noise)
    r = chain.chain_batch(cfg, h, n_trials, num_patterns, bits, noise=noise)
    tx = txofdm.tx_frames(cfg, bits[:frames])
    if is_qam:
        _, llr = modulation.maxlog_llr(r.phasors[:frames], cfg.modulation,
                                       1.0 / cfg.snr_linear)
        llr = llr.reshape(frames, -1).cpu().numpy()
    oracle_launches(dev, cell, {"ofdm_mod": 3, "channel_conv": 2,
                                "sync_search": 1, "equalize": 1})
    x = rxs[:frames].cpu().numpy().astype(np.complex128)
    tx, b = tx.cpu().numpy(), bits[:frames].cpu().numpy()
    hard, ph = r.hard_bits[:frames].cpu().numpy(), r.phasors[:frames].cpu()
    found, lock, delay = (v[:frames].cpu().numpy()
                          for v in (r.found, r.lock_ptr, r.delay_idx))
    t1 = time.perf_counter()
    tx_err = llr_err = 0.0
    near = wrong = 0
    for f in range(frames):
        tx_err = max(tx_err, float(np.abs(tx[f] - qam.tx_frame(cfg, b[f])
                                          ).max()))
        if is_qam:
            o = qam.rx_frame(cfg, x[f])
            tsr, hard_o = o["time_synch_ref"], o["hard_bits"]
            _, llr_o = qam.maxlog_llr(ph[f].numpy().astype(np.complex128),
                                      cfg.modulation, 1.0 / cfg.snr_linear)
            llr_err = max(llr_err, worst_excess(llr[f], llr_o, 2e-3))
        else:
            ph_o, tsr, _ = golden.rx_frame(cfg, x[f])
            hard_o = golden.bit_recovery(ph_o)[0]
        nb = min(len(hard_o), hard.shape[1])
        differ = (hard[f, :nb] != hard_o[:nb]).reshape(-1, cfg.bits_per_bin
                                                       ).any(-1)
        wrong += int((hard_o[:nb] != b[f, :nb]).sum())
        if is_qam:
            bad = int(differ.sum())
        else:
            d = ph_o.reshape(-1)[:len(differ)]
            margin = np.minimum(np.abs(d.real), np.abs(d.imag))
            near += int(differ.sum())
            bad = int((differ & (margin > 2e-4)).sum())
        if (bool(found[f]) != bool(tsr[2] > 0) or lock[f] != int(tsr[0]) or
                delay[f] != int(tsr[1]) or bad):
            raise AssertionError(
                f"{cell} frame {f}: found {bool(found[f])} / "
                f"{bool(tsr[2] > 0)}, lock {lock[f]} / {int(tsr[0])}, delay "
                f"{delay[f]} / {int(tsr[1])} (device / oracle); {bad} "
                f"symbols' hard bits differ"
                f"{'' if is_qam else ' away from a decision boundary'}")
    t2 = time.perf_counter()
    if tx_err > 2e-5 or llr_err > 2e-3:
        raise AssertionError(f"{cell}: TX rows {tx_err:.3e} from the "
                             f"oracle's (allowed 2e-5), LLRs {llr_err:.3e} "
                             "beyond 2e-3 + 2e-3 |llr|")
    llr_txt = (f"; device maxlog_llr within {llr_err:.3e} of the float64 "
               f"oracle's beyond 2e-3 |llr| (allowed 2e-3)" if is_qam else "")
    print(f"{cell} at {cfg.snr_db} dB, {frames} of {batch} frames: "
          f"lock, delay, found == {'qam' if is_qam else 'golden'}.rx_frame "
          f"in every frame, hard bits equal "
          f"({'exactly' if is_qam else f'{near} symbols on a boundary'}; "
          f"the oracle's own bits {wrong} wrong of {frames * nb}); TX rows "
          f"within {tx_err:.2e} of qam.tx_frame (allowed 2e-5){llr_txt}; "
          f"host {t2 - t0:.3f} s (oracle {t2 - t1:.3f} s)")
    return t2 - t0


def oracle_legacy(cfg, dsss, fo_range, cfo_hz, n_stream, blocks, dev,
                  cell) -> float:
    """One legacy case against ``reference_cpu/legacy.py:rx_frame_cfo``:
    the stream ``legacy_run`` makes on the device (``make_legacy_stream``
    of n_stream samples), its first ``blocks`` pattern blocks through the
    port's ``rx_frame_cfo`` on the device (K2) and through the oracle.
    Gates (``tests/test_legacy_rx.py``): count, pointers, delays and
    candidate indices equal; phasors, and with DSSS the despread symbols,
    within 2e-3.  Returns the check's host seconds."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.models import legacy_rx
    from lte_gnu_radio_code_tpu_torch.reference_cpu import legacy

    t0 = time.perf_counter()
    stream, _ = make_legacy_stream(cfg, n_stream, dsss, cfo_hz, dev)
    n = blocks * cfg.pattern_len * cfg.rx_b_len
    max_det = 2 * blocks
    kernels.reset_launch_counts()
    r = legacy_rx.make_legacy_rx(cfg, n, fo_range=fo_range, dsss=dsss,
                                 max_det=max_det, device=dev)(stream[:n])
    oracle_launches(dev, cell, {"equalize": 1})
    x = stream[:n].cpu().numpy().astype(np.complex128)
    count = int(r.count)
    ints = [v[:count].cpu().numpy() for v in (r.ptrs, r.delays, r.fo_idx)]
    floats = [v[:count].cpu().numpy() for v in (r.phasors, r.despread)]
    t1 = time.perf_counter()
    o = legacy.rx_frame_cfo(cfg, x, fo_range=fo_range, dsss=dsss,
                            max_det=max_det)
    t2 = time.perf_counter()
    nd = int(o["n_det"])
    tsr = o["time_synch_ref"][:nd]
    same = count == nd and all(
        np.array_equal(v, tsr[:, c].astype(int))
        for v, c in zip(ints, (0, 1, 3)))
    want = [o["est_data_freq"][:nd]] + ([o["despread"][:nd]] if dsss > 1
                                        else [])
    if not same or max(worst_excess(g, w) for g, w in zip(floats, want)
                       ) > 2e-3:
        raise AssertionError(
            f"{cell}: {count} detections on the device, {nd} in the oracle; "
            f"pointers, delays, candidates equal: {same}; phasors / "
            f"despread within "
            f"{[worst_excess(g, w) for g, w in zip(floats, want)]} "
            "(allowed 2e-3)")
    # a detection off the pattern-block grid equalises by a channel
    # estimate of noise, so its phasors are large and so is their float32
    # rounding: the errors on and off the grid, apart
    on = on_grid(cfg, ints[0])[1]
    parts = []
    for m, where in ((on, "on"), (~on, "off")):
        err = max(worst_excess(g[m], w[m]) for g, w in zip(floats, want))
        parts.append(f"{int(m.sum())} {where} the grid within {err:.2e} "
                     f"(largest |phasor| "
                     f"{float(np.abs(want[0][m]).max(initial=0.0)):.2f})")
    print(f"{cell}, {blocks} blocks ({n} samples) of the legacy stream: "
          f"{nd} detections (candidates "
          f"{np.bincount(ints[2], minlength=len(fo_range)).tolist()}), count, "
          f"pointers, delays and candidates == legacy.rx_frame_cfo; "
          f"phasors{' and despread symbols' if dsss > 1 else ''} of "
          f"{'; '.join(parts)} (allowed 2e-3); host {t2 - t0:.3f} s "
          f"(oracle {t2 - t1:.3f} s)")
    return t2 - t0


def oracle_tracker(cfg, xs, streams, dev, cell) -> float:
    """One tracker cell against ``reference_cpu/tracker.py``: ``make_tracker``
    on the device over the cell's buffers xs [B, n] (the rule's route, K2),
    then ``track_synch`` and ``data_demod(fix_rotation=True)`` on each of
    the first ``streams`` buffers.  Gates (``tests/test_tracker.py``): count
    and the resolved boundary ptr + delay equal, hard bits equal.  Returns
    the check's host seconds."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk
    from lte_gnu_radio_code_tpu_torch.models import tracker
    from lte_gnu_radio_code_tpu_torch.reference_cpu import golden
    from lte_gnu_radio_code_tpu_torch.reference_cpu import tracker as otrk

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    r = tracker.make_tracker(cfg, xs.shape[1], device=dev)(xs)
    oracle_launches(dev, cell, {"tracker": 1, "equalize": 1})
    x = xs[:streams].cpu().numpy().astype(np.complex128)
    count = r.count[:streams].cpu().numpy()
    res = (r.ptrs + r.delays)[:streams].cpu().numpy()
    hard = r.hard_bits[:streams].cpu().numpy()
    t1 = time.perf_counter()
    for b in range(streams):
        tr = otrk.track_synch(cfg, x[b])
        n = tr["n_det"]
        tsr = tr["time_synch_ref"]
        hard_o = golden.bit_recovery(otrk.data_demod(cfg, x[b], tr,
                                                     fix_rotation=True))[0]
        nb = min(len(hard_o), hard.shape[1])
        if (count[b] != n or not np.array_equal(
                res[b, :n], (tsr[:n, 0] + tsr[:n, 1]).astype(int)) or
                not np.array_equal(hard[b, :nb], hard_o[:nb])):
            raise AssertionError(
                f"{cell} stream {b}: {count[b]} detections on the device, "
                f"{n} in the oracle; ptr + delay differ in "
                f"{int((res[b, :n] != tsr[:n, 0] + tsr[:n, 1]).sum())}, "
                f"hard bits in {int((hard[b, :nb] != hard_o[:nb]).sum())}")
    t2 = time.perf_counter()
    print(f"{cell}, {streams} of {len(xs)} streams on the {ktrk.route(cfg)} "
          f"route: count ({n} a stream), ptr + delay and hard bits == "
          f"tracker.track_synch / data_demod; host {t2 - t0:.3f} s (oracle "
          f"{t2 - t1:.3f} s)")
    return t2 - t0


def oracle_pls(batch, n, dev, cell) -> float:
    """The PLS cell against ``reference_cpu/pls.py``, on n of ``batch``
    exchanges: unitaries drawn on the device through ``ops.pls.transmit``
    and the oracle's ``transmit`` (within 1e-5); those buffers over
    ``pls_channels``' flat channel (delay PLS_DELAY) at PLS_SNR_DB, locked
    and received on the device (``receive_synced``), the oracle's
    ``receive`` on the frame cut at the device's lock: lock PLS_DELAY,
    left singular vectors within 1e-3 (``tests/test_pls.py``); then
    ``key_exchange`` on the device and the oracle's, each with its own
    unitaries, over each of ``pls_channels``' channels without its delay
    (the oracle's receive has perfect timing): both give back every key.
    Returns the check's host seconds."""
    from lte_gnu_radio_code_tpu_torch.models import pls
    from lte_gnu_radio_code_tpu_torch.ops import pls as pls_ops
    from lte_gnu_radio_code_tpu_torch.reference_cpu import pls as opls
    from lte_gnu_radio_code_tpu_torch.utils.params import PLSConfig

    t0 = time.perf_counter()
    cfg = PLSConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    u = pls_ops.random_unitary(
        gen, (batch, cfg.num_data_symb, cfg.num_subbands), cfg.num_ant)
    tx = pls_ops.transmit(cfg, u)
    _, h_flat, want = pls_channels()[0]
    rx = pls.mimo_channel(cfg, tx, h_flat, PLS_SNR_DB, generator=gen,
                          out_len=cfg.frame_len + PLS_MAX_DELAY)
    lsv, _, _, _, lock = pls_ops.receive_synced(cfg, rx, PLS_MAX_DELAY)
    keys = torch.randint(0, 2, (batch, cfg.pvt_info_len), generator=gen,
                         device=dev, dtype=torch.int32)
    chans = [(name, h[:, :, PLS_DELAY:]) for name, h, _ in pls_channels()]
    got = {name: pls.key_exchange(cfg, keys, gen, h0, device=dev)[0][:n]
           for name, h0 in chans}
    u, tx, rx, lsv, lock = (v[:n].cpu().numpy() for v in (u, tx, rx, lsv,
                                                           lock))
    keys = keys[:n].cpu().numpy()
    got = {name: v.cpu().numpy() for name, v in got.items()}
    t1 = time.perf_counter()
    ref = opls.ref_signal(cfg)
    tx_err = lsv_err = 0.0
    for i in range(n):
        tx_o = opls.transmit(cfg, u[i].astype(np.complex128), ref)
        tx_err = max(tx_err, float(np.abs(tx[i] - tx_o).max()))
        frame = rx[i][:, lock[i]:lock[i] + cfg.frame_len]
        lsv_o = opls.receive(cfg, frame.astype(np.complex128), ref)[0]
        lsv_err = max(lsv_err, float(np.abs(lsv[i] - lsv_o).max()))
    wrong = {}
    for name, h0 in chans:
        wrong[name] = sum(
            int((got[name][i] != keys[i]).sum()) + int((opls.key_exchange(
                cfg, keys[i], np.random.default_rng(SEED + i), h0)[0] !=
                keys[i]).sum()) for i in range(n))
    t2 = time.perf_counter()
    if (tx_err > 1e-5 or lsv_err > 1e-3 or not (lock == want).all() or
            any(wrong.values())):
        raise AssertionError(f"{cell}: TX {tx_err:.3e} from the oracle's "
                             f"(allowed 1e-5), left singular vectors "
                             f"{lsv_err:.3e} (allowed 1e-3), locks "
                             f"{np.unique(lock).tolist()} (expected {want}), "
                             f"key bits wrong (device + oracle) {wrong}")
    print(f"{cell}, {n} of {batch} exchanges: TX within {tx_err:.2e} of "
          f"pls.transmit (allowed 1e-5); at {PLS_SNR_DB} dB over the flat "
          f"channel delayed by {PLS_DELAY} every lock {want} and the left "
          f"singular vectors within {lsv_err:.2e} of pls.receive (allowed "
          f"1e-3); key_exchange on the device and pls.key_exchange both give "
          f"back all {n} keys over the {' and '.join(wrong)} channels; host "
          f"{t2 - t0:.3f} s (oracle {t2 - t1:.3f} s)")
    return t2 - t0


def oracle_run(dev, gpu) -> None:
    """The oracle group: the chain cells GOLDEN64 b128 and LTE1024 b32,
    GOLDEN64 QAM64 b128 at its own 24 dB, legacy CFO case 7 (+1500 Hz) and
    DSSS case 9, the tracker at GOLDEN64 B 16, LTE1024 and LTE2048 B 4,
    and PLS b256, each against the port's numpy oracle on the same buffers
    (``oracle_chain``, ``oracle_legacy``, ``oracle_tracker``,
    ``oracle_pls``).  Prints each check's host seconds and the group's."""
    from lte_gnu_radio_code_tpu_torch.utils import params

    print(f"oracle group on {gpu}; the oracles run on the host's "
          f"{host_cpu()}")
    secs = []
    for cfg_name, batch in CELLS[:2]:
        secs.append(oracle_chain(getattr(params, cfg_name), batch,
                                 ORACLE_FRAMES, dev,
                                 f"oracle {cfg_name} b{batch}"))
    name, source, changes, batch, _ = QAM_CELLS[0]
    secs.append(oracle_chain(config_of(source, changes), batch,
                             ORACLE_FRAMES, dev, f"oracle {name} b{batch}"))
    print("oracle: the two pilot cells of QAM_CELLS are left out: "
          "reference_cpu/qam.py has no pilot grid")
    for table, case, fo_range, cfo_hz in (LEGACY[0], LEGACY[2]):
        cases = getattr(params, table)
        cfg = params.config_from_case(cases, case)
        chunk_len, k = legacy_chunks(cfg)
        secs.append(oracle_legacy(
            cfg, cases[case]["dsss"], fo_range, cfo_hz, k * chunk_len,
            ORACLE_LEGACY_BLOCKS, dev,
            f"oracle {table[:-6]} case {case} ({cfo_hz:+.0f} Hz)"))
    for cfg_name, batch, snr_db in (TRACKER, *TRACKER_LTE):
        cfg = getattr(params, cfg_name)
        xs, _ = tracker_streams(cfg, batch, snr_db, dev)
        secs.append(oracle_tracker(cfg, xs, ORACLE_TRACKER_STREAMS, dev,
                                   f"oracle {cfg_name} tracker B {batch}"))
    secs.append(oracle_pls(PLS_BATCH, ORACLE_PLS, dev,
                           f"oracle PLS b{PLS_BATCH}"))
    print(f"oracle group: every gate held; {sum(secs):.3f} s of host time "
          f"({', '.join(f'{t:.3f}' for t in secs)}) on {gpu}")


def native_check(dev, gpu) -> tuple:
    """The host ingest path: one LTE1024 stream made on the card, copied to
    the host, written into a NativeRing in uneven pieces of at most 4095
    samples, and pumped by a NativeChunker in chunks of 65280 into a
    ReacqStreamingRx on the card.  Its outputs equal those of the same
    chunks pushed from the card and, but for float rounding, those of the
    plain receiver (CPU copies) on the ring's chunks; every whole pattern
    block is detected once with the sent bits, one K4 and one K2 launch a
    step; times of the whole path and of a step fed from the ring's host
    chunks.  Returns (cell, launch counts of the ring-fed run, K4 and K2
    against their plain versions at this path's shapes)."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.runtime import native
    from lte_gnu_radio_code_tpu_torch.runtime import stream as rt
    from lte_gnu_radio_code_tpu_torch.utils import params

    cfg_name, chunk, k, quantum = NATIVE
    cfg = getattr(params, cfg_name)
    cell = f"{cfg_name} native ring, chunk {chunk} x {k}"
    streams, bits = make_streams(cfg, 1, k * chunk, dev)
    host = streams[0].cpu()
    sizes = np.random.default_rng(SEED + 9).integers(1, quantum + 1,
                                                     len(host))
    ring = native.NativeRing(4 * chunk)
    chunker = native.NativeChunker(ring, chunk)
    rx = rt.ReacqStreamingRx(cfg, chunk)
    rx.push(torch.zeros(chunk, dtype=torch.complex64))      # warm-up
    rx = rt.ReacqStreamingRx(cfg, chunk)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs, host_chunks, pos, i = [], [], 0, 0
    t0 = time.perf_counter()
    while pos < len(host):
        pos += ring.write(host[pos:pos + sizes[i]])
        i += 1
        while (c := chunker.pump()) is not None:
            host_chunks.append(c)
            outs.append(rx.push(c))
    outs += rx.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    direct = rt.ReacqStreamingRx(cfg, chunk)
    ref = [direct.push(c) for c in streams[0].reshape(k, chunk)]
    ref += direct.finish()
    got = stack_outs(outs)
    same_outs(got, stack_outs(ref), f"{cell}: ring-fed vs pushed directly")
    plain_rx = rt.ReacqStreamingRx(cfg, chunk, device="cpu")
    before = kernels.launch_counts()
    plain = moved(stack_outs([plain_rx.push(c.cpu()) for c in host_chunks] +
                             plain_rx.finish()), dev)
    if kernels.launch_counts() != before:
        raise AssertionError(f"{cell}: the plain receiver launched a kernel")
    worst = same_outs(got, plain, f"{cell}: ring-fed kernel vs "
                      "plain receiver", float_atol=2e-4, skip=("peaks",))
    if (len(host_chunks) != k or chunker.staged or
            counts["sync_search"] != len(outs) or
            counts["equalize"] != len(outs)):
        raise AssertionError(f"{cell}: {len(host_chunks)} chunks pumped "
                             f"({chunker.staged} staged), launches {counts} "
                             f"over {len(outs)} steps")
    check_detections(cfg, type(got)(*(f[:, None] for f in got)), bits,
                     k * chunk, cell)
    prx = rt.ReacqStreamingRx(cfg, chunk)
    times = []
    for _ in range(SERVING_ROUNDS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for c in host_chunks:
            prx.push(c)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3 / k)
    step_ms = sorted(times)[len(times) // 2]
    busy, launches = profile(lambda j: prx.push(host_chunks[j % k]), cell)
    print(f"{cell}: {i} writes of at most {quantum} samples, {k} chunks "
          f"pumped; outputs == the chunks pushed from the card; kernel "
          f"receiver == plain receiver (CPU copies) on the ring's chunks: "
          f"ptrs, delays, valid, demod_ok, hard bits equal, phasors and "
          f"chans within {worst:.2e} (allowed 2e-4); launches "
          f"{counts}; the whole path (ring writes, pumps, pushes, flush) "
          f"{wall * 1e3:.3f} ms, {k * chunk / wall / 1e6:.3f} Msamples/s; a "
          f"step fed from a host chunk {step_ms:.3f} ms (rounds "
          f"{', '.join(f'{t:.3f}' for t in times)}), "
          f"{chunk / step_ms / 1e3:.3f} Msamples/s; device busy "
          f"{busy:.3f} ms a step, idle share {1 - busy / step_ms:.3f}, "
          f"{launches:.1f} device launches a step, on {gpu}")
    ext, t_per, _, win, coeff, _ = step_inputs(cfg, streams, chunk,
                                               rx.det_max)
    checks = {"sync_search": sync_checks(cfg, 1, ext, t_per, cell),
              "equalize": equalize_check(cfg, win, coeff)}
    print_kernel_rows(cell, checks)
    return cell, counts, checks


def wall_ms(fn, reps=CHAIN_REPS) -> tuple[float, list]:
    """Host ms a call of fn(i), each round of reps calls ending in a
    synchronize: (the median of CHAIN_ROUNDS rounds, every round's)."""
    fn(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(CHAIN_ROUNDS):
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / reps)
    return sorted(times)[len(times) // 2], times


@contextlib.contextmanager
def kernel_inputs():
    """What the path run inside hands K4's, K2's and the tracker's
    wrappers: {"sync_search": [(x, n_trials), ...], "equalize": [(win,
    coeff), ...], "tracker": [(x, x_start, fire_limit, carry, steps,
    max_det), ...]}, call by call."""
    from lte_gnu_radio_code_tpu_torch.kernels import equalize, sync_search
    from lte_gnu_radio_code_tpu_torch.kernels import tracker as ktrk

    seen = {"sync_search": [], "equalize": [], "tracker": []}
    k4, k4p, k2, scan = (sync_search.sync_corr_abs, sync_search.sync_peaks,
                         equalize.demod_windows, ktrk.track_scan)

    def search(cfg, x, n_trials, zc=None):
        seen["sync_search"].append((x, n_trials))
        return k4(cfg, x, n_trials, zc)

    def peaks(cfg, x, n_trials, zc=None):
        seen["sync_search"].append((x, n_trials))
        return k4p(cfg, x, n_trials, zc)

    def demod(cfg, win, coeff):
        seen["equalize"].append((win, coeff))
        return k2(cfg, win, coeff)

    def track(cfg, *args):
        seen["tracker"].append(args)
        return scan(cfg, *args)

    sync_search.sync_corr_abs, equalize.demod_windows = search, demod
    sync_search.sync_peaks, ktrk.track_scan = peaks, track
    try:
        yield seen
    finally:
        sync_search.sync_corr_abs, equalize.demod_windows = k4, k2
        sync_search.sync_peaks, ktrk.track_scan = k4p, scan


def path_checks(cfg, seen, cell, step=0) -> dict:
    """K4 (where the path ran it) and K2 against their plain versions on
    what the path handed them in its step-th call (:func:`kernel_inputs`);
    K4's rows are the shards (of every frame) on a sharded path."""
    out = {}
    if seen["sync_search"]:
        x, n_trials = seen["sync_search"][step]
        x = x.reshape(-1, x.shape[-1])
        out["sync_search"] = sync_checks(cfg, x.shape[0], x, n_trials, cell)
    win, coeff = seen["equalize"][step]
    out["equalize"] = equalize_check(cfg, win, coeff)
    print_kernel_rows(cell, out)
    return out


def fit_halo(cfg, t):
    """Double the symbol count until each of t shards covers the halo
    (``__graft_entry__.py:fit_halo``)."""
    import dataclasses
    from lte_gnu_radio_code_tpu_torch.parallel import sharded
    while cfg.frame_len // t < sharded.halo_size(cfg):
        cfg = dataclasses.replace(
            cfg, num_ofdm_symb=2 * cfg.num_ofdm_symb).validate()
    return cfg


def twin_line(cell, what, ms, busy, launches, twin, t_ms, t_busy,
              t_launches, gpu) -> str:
    return (f"{cell}: {what} {ms:.3f} ms a step, device busy {busy:.3f}, "
            f"idle share {1 - busy / ms:.3f}, {launches:.1f} device launches "
            f"a step; {twin} at the same shape in this run {t_ms:.3f} ms, "
            f"busy {t_busy:.3f}, idle share {1 - t_busy / t_ms:.3f}, "
            f"{t_launches:.1f} launches; sharded / unsharded "
            f"{ms / t_ms:.3f}x, on {gpu}")


def sharded_rx_run(dev, gpu) -> list:
    """The time-sharded RX (``parallel/sharded.py``) on one frame made on
    the card (K1, K3, AWGN 100 dB) at each SHARDED_RX shape: one K4 and one
    K2 launch a call on the route the rule names; found, lock, delay and
    hard bits equal to the plain path's (CPU copies) and to the
    single-device ``rx_frame`` on the kernels, phasors within 2e-4 and the
    peak within K4's tolerance, the bits the sent ones; K4 and K2 against
    their plain versions on what the sharded call handed them; ms a call
    beside ``rx_frame``'s.  Returns the ``kernels`` line's entries."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.kernels import sync_search
    from lte_gnu_radio_code_tpu_torch.models import chain, rxofdm
    from lte_gnu_radio_code_tpu_torch.parallel import mesh, sharded
    from lte_gnu_radio_code_tpu_torch.utils import params

    entries = []
    for cfg_name, shard_counts in SHARDED_RX:
        for t in shard_counts:
            cfg = fit_halo(getattr(params, cfg_name), t)
            cell = f"{cfg_name} sharded RX t{t}"
            gen = torch.Generator(device=dev).manual_seed(SEED + 10)
            bits = torch.randint(0, 2, (1, cfg.num_bits), generator=gen,
                                 device=dev, dtype=torch.int32)
            x = chain.transmit(cfg, chain.loopback_taps(cfg), bits,
                               generator=gen)[0]
            n = x.shape[0]
            n_trials, num_patterns = rxofdm.plan_rx(cfg, n)
            rx = sharded.make_sharded_rx(cfg, n, mesh.time_mesh(t))
            rx(x)                                       # warm-up
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            r = rx(x)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            routes = dict(sync_search.route_launches)
            want = sync_search.route(cfg.nfft, cfg.cp_len, cfg.stride,
                                     cfg.m_synch)
            if counts != {**dict.fromkeys(kernels.KERNEL_MODULES, 0),
                          "sync_search": 1, "equalize": 1} or \
                    routes != {"fft": 0, "direct": 0, want: 1}:
                raise AssertionError(f"{cell}: launches {counts}, by route "
                                     f"{routes}, expected one K4 ({want}) "
                                     "and one K2")
            plain = moved(sharded.make_sharded_rx(
                cfg, n, mesh.time_mesh(t, device="cpu"))(x.cpu()), dev)

            def single(i=0):
                return rxofdm.rx_frame(cfg, x, n_trials, num_patterns)

            worst = peak_err = 0.0
            peak_tol = (dict(atol=2e-3, rtol=0.0) if cfg.stride == 1
                        else dict(atol=3e-3, rtol=2e-4))   # K4's, as compare
            for what, ref in (("plain path", plain),
                              ("single-device rx_frame", single())):
                for name in ("found", "lock_ptr", "delay_idx", "hard_bits"):
                    if not torch.equal(getattr(r, name), getattr(ref, name)):
                        raise AssertionError(f"{cell}: {name} differs from "
                                             f"the {what}'s")
                err = float((r.phasors - ref.phasors).abs().max())
                worst = max(worst, err)
                if err > 2e-4:
                    raise AssertionError(f"{cell}: phasors differ from the "
                                         f"{what}'s by {err}")
                peak_err = max(peak_err, float((r.peak - ref.peak).abs()))
                if not torch.allclose(r.peak, ref.peak, **peak_tol):
                    raise AssertionError(f"{cell}: peak {float(r.peak)}, the "
                                         f"{what}'s {float(ref.peak)}")
            nb = min(r.hard_bits.shape[-1], cfg.num_bits)
            if not bool(r.found) or not torch.equal(r.hard_bits[:nb],
                                                    bits[0, :nb]):
                raise AssertionError(f"{cell}: found {bool(r.found)}, "
                                     f"{int((r.hard_bits[:nb] != bits[0, :nb]).sum())}"
                                     " bits differ from the sent ones")
            ms, rounds = wall_ms(lambda i: rx(x))
            one_ms, _ = wall_ms(single)
            busy, launches = profile(lambda i: rx(x), cell, top=0)
            one_busy, one_launches = profile(single, cell, top=0)
            print(f"{cell} ({n} samples, {n // t} a shard + halo "
                  f"{sharded.halo_size(cfg)}): locked at "
                  f"{int(r.lock_ptr)}, delay {int(r.delay_idx)}, bits == sent "
                  f"bits; == plain path and == rx_frame in found, lock, "
                  f"delay, bits, phasors within {worst:.2e}, peak within "
                  f"{peak_err:.2e}; launches {counts} on the {want} route; "
                  f"rounds {', '.join(f'{v:.3f}' for v in rounds)}")
            print(twin_line(cell, "a call", ms, busy, launches, "rx_frame",
                            one_ms, one_busy, one_launches, gpu))
            with kernel_inputs() as seen:
                rx(x)
            for name, c in path_checks(cfg, seen, cell).items():
                entries.append(kernel_entry(name, cell, counts[name], c))
    return entries


def sharded_chain_run(cfg_name, batch, t, dev, gpu) -> tuple:
    """The dp x t chain (``parallel/chain.py``) at one shape, dp 2 in this
    process: on one noise tensor found, lock and BER equal to
    ``chain_batch``'s, every frame locked with BER 0; one launch of each of
    K1-K4 a step; ms a step and Msamples/s (median of three rounds of 20)
    beside ``chain_batch``'s.  Returns (cell, launches of a step, K4 and K2
    at the sharded shapes)."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.models import chain, rxofdm
    from lte_gnu_radio_code_tpu_torch.parallel import chain as pchain
    from lte_gnu_radio_code_tpu_torch.parallel import mesh
    from lte_gnu_radio_code_tpu_torch.utils import params

    cfg = fit_halo(getattr(params, cfg_name), t)
    cell = f"{cfg_name} dp2 x t{t} chain b{batch}"
    rng = np.random.default_rng(SEED + 1)
    bits = torch.as_tensor(rng.integers(0, 2, (batch, cfg.num_bits),
                                        dtype=np.int32), device=dev)
    h = chain.loopback_taps(cfg)
    n = cfg.frame_len + cfg.nfft - 1
    n_trials, num_patterns = rxofdm.plan_rx(cfg, n)
    step = pchain.make_sharded_chain(cfg, mesh.make_mesh(2 * t, dp=2))
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    noise = torch.complex(torch.randn(batch, n, generator=gen, device=dev),
                          torch.randn(batch, n, generator=gen, device=dev))
    step(bits, noise=noise)                             # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    ber, found, lock = step(bits, noise=noise)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    ref = chain.chain_batch(cfg, h, n_trials, num_patterns, bits, noise=noise)
    if counts != {**dict.fromkeys(kernels.KERNEL_MODULES, 1), "tracker": 0,
                  "mimo_detect": 0}:
        raise AssertionError(f"{cell}: launches {counts}, expected one of "
                             "each of K1-K4")
    if not bool(found.all()) or float(ber.max()) != 0.0:
        raise AssertionError(f"{cell}: {int((~found).sum())} frames "
                             f"unlocked, worst BER {float(ber.max())}")
    if not (torch.equal(ber, ref.ber) and torch.equal(found, ref.found) and
            torch.equal(lock, ref.lock_ptr)):
        raise AssertionError(f"{cell}: BER, found or lock differ from "
                             "chain_batch's on the same noise")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def sharded_step(i):
        return step(bits ^ (i & 1), generator=gen)

    def batch_step(i):
        return chain.chain_batch(cfg, h, n_trials, num_patterns,
                                 bits ^ (i & 1), generator=gen)

    ms, rounds = wall_ms(sharded_step)
    b_ms, b_rounds = wall_ms(batch_step)
    busy, launches = profile(sharded_step, cell, top=0)
    b_busy, b_launches = profile(batch_step, cell, top=0)
    msps = batch * n / ms / 1e3
    print(f"{cell}: all {batch} frames locked, BER 0, BER / found / lock == "
          f"chain_batch's on the same noise; launches {counts}; "
          f"{msps:.3f} Msamples/s (chain_batch {batch * n / b_ms / 1e3:.3f}); "
          f"rounds {', '.join(f'{v:.3f}' for v in rounds)} (chain_batch "
          f"{', '.join(f'{v:.3f}' for v in b_rounds)})")
    print(twin_line(cell, "sharded chain", ms, busy, launches, "chain_batch",
                    b_ms, b_busy, b_launches, gpu))
    with kernel_inputs() as seen:
        step(bits, noise=noise)
    return cell, counts, path_checks(cfg, seen, cell)


def stream_times(make, chunks, cell, top=0):
    """ms a chunk step of a push_many on a receiver from make(), warmed by
    one push (a reacq receiver captures its CUDA graph there) and its carry
    zeroed, the empty carry, before each round (median of SERVING_ROUNDS,
    and every round's), and busy ms and launches a step from a profile of
    single pushes (its top kernels printed)."""
    k = len(chunks)
    times = []
    rx = make()
    rx.push(chunks[0])
    for _ in range(SERVING_ROUNDS):
        for t in rx.state:
            t.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rx.push_many(chunks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / k)
    busy, launches = profile(lambda i: rx.push(chunks[i % k]), cell, top=top)
    return sorted(times)[len(times) // 2], times, busy, launches


def sharded_stream_run(cfg_name, chunk_len, k, t, dev, gpu) -> tuple:
    """``ShardedReacqStreamingRx`` (``parallel/streaming.py``) on one
    stream made on the card: == ``ReacqStreamingRx`` on the same chunks
    (every integer field, floats within 2e-4) and == ``rx_detections`` on
    the whole buffer; every whole pattern block detected once with the
    sent bits; ``push_many`` == pushes; one K4 (on the rule's route) and
    one K2 launch a step; no host synchronisation in a step; ms a step
    beside the unsharded receiver's.  Returns (cell, launch counts of the
    main-path run, K4 and K2 at the sharded shapes)."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.kernels import sync_search
    from lte_gnu_radio_code_tpu_torch.parallel import mesh, streaming
    from lte_gnu_radio_code_tpu_torch.runtime import stream as rt
    from lte_gnu_radio_code_tpu_torch.utils import params

    cfg = getattr(params, cfg_name)
    cell = f"{cfg_name} sharded stream t{t}, chunk {chunk_len} x {k}"
    n_real = k * chunk_len
    streams, bits = make_streams(cfg, 1, n_real, dev)
    chunks = streams[0].reshape(k, chunk_len)
    m = mesh.time_mesh(t)

    def make(**kw):
        return streaming.ShardedReacqStreamingRx(cfg, chunk_len, m, **kw)

    make().push(chunks[0])                              # warm-up
    rx = make()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    many = rx.push_many(chunks)
    outs = cat_outs([many, stack_outs(rx.finish())])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    routes = dict(sync_search.route_launches)
    steps = outs.valid.shape[0]
    want = sync_search.route(cfg.nfft, cfg.cp_len, cfg.stride, cfg.m_synch)
    if counts != {**dict.fromkeys(kernels.KERNEL_MODULES, 0),
                  "sync_search": steps, "equalize": steps} or \
            routes != {"fft": 0, "direct": 0, want: steps}:
        raise AssertionError(f"{cell}: {steps} chunk steps, launches "
                             f"{counts}, by route {routes}")
    one = rt.ReacqStreamingRx(cfg, chunk_len)
    ref = cat_outs([one.push_many(chunks), stack_outs(one.finish())])
    worst = same_outs(outs, ref, f"{cell}: sharded vs ReacqStreamingRx",
                      float_atol=2e-4)
    check_detections(cfg, type(outs)(*(f[:, None] for f in outs)), bits,
                     n_real, cell)
    nb = same_as_whole(cfg, outs, streams[0], n_real, cell)
    srx = make()
    same_outs(stack_outs([srx.push(c) for c in chunks]), many,
              f"{cell}: pushes vs push_many")
    print(f"{cell}: {steps} chunk steps (det_max {rx.det_max}): launches "
          f"{counts} on the {want} route; == ReacqStreamingRx on the same "
          f"chunks (integer fields equal, floats within {worst:.2e} of "
          f"max(1, |value|)); == rx_detections on the whole buffer ({nb} "
          f"detections); push_many == {k} pushes exactly")
    no_host_sync(srx, chunks[0], cell)
    ms, rounds, busy, launches = stream_times(make, chunks, cell)
    u_ms, _, u_busy, u_launches = stream_times(
        lambda: rt.ReacqStreamingRx(cfg, chunk_len), chunks, cell)
    print(f"{cell}: push_many of {k} chunks {n_real / ms / 1e3:.3f} "
          f"Msamples/s (unsharded {n_real / u_ms / 1e3:.3f}); rounds "
          f"{', '.join(f'{v:.3f}' for v in rounds)}")
    print(twin_line(cell, "sharded chunk step", ms, busy, launches,
                    "ReacqStreamingRx", u_ms, u_busy, u_launches, gpu))
    with kernel_inputs() as seen:
        make().push_many(chunks[:2])
    return cell, counts, path_checks(cfg, seen, cell, step=1)


def sharded_legacy_run(table, case, fo_range, cfo_hz, chunk_len, t, dev,
                       gpu) -> tuple:
    """``ShardedLegacyStreamingRx`` on a stream of over a million samples
    made on the card (``make_legacy_stream``): == ``LegacyStreamingRx`` on
    the same chunks (integer fields equal, floats within 2e-4), the
    detections against what was sent (``check_legacy_detections``),
    ``push_many`` == pushes, one K2 launch and no other kernel a step, no
    host synchronisation; ms a step beside the unsharded receiver's.
    Returns (cell, K2 launches of the main-path run, K2 at the sharded
    shape)."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.parallel import mesh, streaming
    from lte_gnu_radio_code_tpu_torch.runtime import stream as rt
    from lte_gnu_radio_code_tpu_torch.utils import params

    cases = getattr(params, table)
    cfg = params.config_from_case(cases, case)
    dsss = cases[case]["dsss"]
    k = -(-LEGACY_SAMPLES // chunk_len)
    n_real = k * chunk_len
    cell = (f"{table[:-6]} case {case} sharded stream t{t} ({cfo_hz:+.0f} "
            f"Hz, chunk {chunk_len} x {k})")
    stream, sent = make_legacy_stream(cfg, n_real, dsss, cfo_hz, dev)
    chunks = stream.reshape(k, chunk_len)
    m = mesh.time_mesh(t)

    def make(**kw):
        return streaming.ShardedLegacyStreamingRx(
            cfg, chunk_len, m, fo_range=fo_range, dsss=dsss, **kw)

    make().push(chunks[0])                              # warm-up
    rx = make()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    many = rx.push_many(chunks)
    outs = cat_outs([many, stack_outs(rx.finish())])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    steps = outs.valid.shape[0]
    if counts != {**dict.fromkeys(kernels.KERNEL_MODULES, 0),
                  "equalize": steps}:
        raise AssertionError(f"{cell}: {steps} chunk steps, launches "
                             f"{counts}, expected one K2 launch a step and "
                             "no other kernel")

    def unsharded():
        return rt.LegacyStreamingRx(cfg, chunk_len, fo_range=fo_range,
                                    dsss=dsss)

    one = unsharded()
    ref = cat_outs([one.push_many(chunks), stack_outs(one.finish())])
    worst = same_outs(outs, ref, f"{cell}: sharded vs LegacyStreamingRx",
                      float_atol=2e-4)
    want_fo = fo_range.index(-cfo_hz) if cfo_hz else 0
    check_legacy_detections(cfg, outs, sent, n_real, want_fo,
                            every_block=not cfo_hz, cell=cell)
    srx = make()
    same_outs(stack_outs([srx.push(c) for c in chunks]), many,
              f"{cell}: pushes vs push_many")
    print(f"{cell}: {steps} chunk steps (det_max {rx.det_max}): launches "
          f"{counts}; == LegacyStreamingRx on the same chunks (integer "
          f"fields equal, floats within {worst:.2e} of max(1, |value|)); "
          f"push_many == {k} pushes exactly")
    no_host_sync(srx, chunks[0], cell)
    ms, rounds, busy, launches = stream_times(make, chunks, cell)
    u_ms, _, u_busy, u_launches = stream_times(unsharded, chunks, cell)
    print(f"{cell}: push_many of {k} chunks {n_real / ms / 1e3:.3f} "
          f"Msamples/s (unsharded {n_real / u_ms / 1e3:.3f}); rounds "
          f"{', '.join(f'{v:.3f}' for v in rounds)}")
    print(twin_line(cell, "sharded chunk step", ms, busy, launches,
                    "LegacyStreamingRx", u_ms, u_busy, u_launches, gpu))
    with kernel_inputs() as seen:
        make().push_many(chunks[:2])
    return cell, counts["equalize"], path_checks(cfg, seen, cell,
                                                     step=1)["equalize"]


def multihost_inputs(cfg, frames, dev):
    """The global batch's bits and noise, the same in every process."""
    bits = torch.as_tensor(np.random.default_rng(SEED + 12).integers(
        0, 2, (frames, cfg.num_bits), dtype=np.int32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    n = cfg.frame_len + cfg.nfft - 1
    noise = torch.complex(torch.randn(frames, n, generator=gen, device=dev),
                          torch.randn(frames, n, generator=gen, device=dev))
    return bits, noise


def multihost_worker(pid: int, nproc: int, coord: str, out: str) -> None:
    """One process of ``multihost_run``: gloo over tcp://coord, the dp x t
    chain on its own frames on cuda:0, the results gathered; rank 0 writes
    them to ``out``."""
    import torch.distributed as dist
    from lte_gnu_radio_code_tpu_torch.parallel import chain as pchain
    from lte_gnu_radio_code_tpu_torch.parallel import multihost
    from lte_gnu_radio_code_tpu_torch.utils import params

    cfg_name, frames, t = MULTIHOST
    cfg = getattr(params, cfg_name)
    multihost.init_distributed(coord, nproc, pid, backend="gloo")
    mesh = multihost.multihost_mesh(t=t)
    dev = mesh.device
    bits, noise = multihost_inputs(cfg, frames * nproc, dev)
    ber, found, lock = pchain.make_sharded_chain(cfg, mesh)(bits,
                                                            noise=noise)
    if len(ber) != frames or not bool(found.all()) or float(ber.max()):
        raise AssertionError(f"rank {pid}: {len(ber)} frames, "
                             f"{int((~found).sum())} unlocked, worst BER "
                             f"{float(ber.max())}")
    ber, found, lock = multihost.gather_frames(mesh, ber, found, lock)
    if pid == 0:
        np.savez(out, ber=ber.numpy(), found=found.numpy(),
                 lock=lock.numpy())
    dist.barrier()
    dist.destroy_process_group()
    print(f"MULTIHOST_OK rank={pid} world={nproc} backend=gloo "
          f"mesh=dp{mesh.shape['dp']}xt{t} frames={frames} device={dev}",
          flush=True)


def nccl_worker(coord: str) -> None:
    """A world-size-1 group with the default backend on the card: NCCL."""
    import torch.distributed as dist
    from lte_gnu_radio_code_tpu_torch.parallel import multihost

    multihost.init_distributed(coord, 1, 0)
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    backend = dist.get_backend()
    if backend != "nccl" or float(x.sum()) != 4.0:
        raise AssertionError(f"backend {backend}, all_reduce {x.tolist()}")
    dist.destroy_process_group()
    print("NCCL_OK world=1", flush=True)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_run(dev, gpu) -> None:
    """Two worker processes of this script on cuda:0 over gloo, dp = 2 x t
    = 2, MULTIHOST frames each, and beside them a world-size-1 process
    group on the default backend (NCCL; it refuses two ranks on one card).
    Every worker exits 0 with its OK line (each frame locked, BER 0), and
    rank 0's gathered results equal this process's chain on the same
    injected noise."""
    from lte_gnu_radio_code_tpu_torch.parallel import chain as pchain
    from lte_gnu_radio_code_tpu_torch.parallel import mesh
    from lte_gnu_radio_code_tpu_torch.utils import params

    cfg_name, frames, t = MULTIHOST
    cfg = getattr(params, cfg_name)
    cell = f"{cfg_name} 2 processes, dp2 x t{t}, {frames} frames each"
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/gathered.npz"
        coord = f"127.0.0.1:{free_port()}"
        argv = [[sys.executable, __file__, "--multihost-worker", str(pid),
                 "2", coord, out] for pid in range(2)]
        argv.append([sys.executable, __file__, "--nccl-worker",
                     f"127.0.0.1:{free_port()}"])
        t0 = time.perf_counter()
        procs = [subprocess.Popen(a, cwd=REPO, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for a in argv]
        texts = []
        try:
            for p in procs:
                texts.append(p.communicate(timeout=MULTIHOST_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        oks = [f"MULTIHOST_OK rank={pid} world=2" for pid in range(2)]
        oks.append("NCCL_OK world=1")
        for p, text, ok in zip(procs, texts, oks):
            if p.returncode != 0 or ok not in text:
                raise AssertionError(f"{cell}: worker exit {p.returncode}, "
                                     f"output:\n{text[-4000:]}")
        got = np.load(out)
        bits, noise = multihost_inputs(cfg, 2 * frames, dev)
        ber, found, lock = pchain.make_sharded_chain(
            cfg, mesh.make_mesh(2 * t, dp=2))(bits, noise=noise)
        for name, v in (("ber", ber), ("found", found), ("lock", lock)):
            if not np.array_equal(got[name], v.cpu().numpy()):
                raise AssertionError(f"{cell}: gathered {name} differs from "
                                     "one process's chain")
    for text in texts:
        print("  " + text.strip().splitlines()[-1])
    print(f"{cell}: both gloo workers on cuda:0 and the NCCL group of one "
          f"exited 0 ({wall:.1f} s with start-up); every frame locked with "
          f"BER 0; rank 0's gathered ber, found, lock == one process's "
          f"chain on the same noise, on {gpu}")


def cards_config(job):
    from lte_gnu_radio_code_tpu_torch.utils import params
    if job["kind"] == "legacy":
        return params.config_from_case(getattr(params, job["table"]),
                                       job["case"])
    return fit_halo(getattr(params, job["cfg"]), job["t"])


def cards_jobs(dev) -> tuple[dict, dict]:
    """The buffers of ``cards_run``, made on the card as the sharded phases
    make theirs and copied to the host, by cell: the jobs of the
    2-process group (CARDS_RX, CARDS_STREAM, CARDS_LEGACY) and the chain's
    (CARDS_CHAIN)."""
    from lte_gnu_radio_code_tpu_torch.models import chain
    from lte_gnu_radio_code_tpu_torch.utils import params

    jobs = {}
    for cfg_name, t in CARDS_RX:
        job = dict(kind="rx", cfg=cfg_name, t=t)
        cfg = cards_config(job)
        gen = torch.Generator(device=dev).manual_seed(SEED + 10)
        bits = torch.randint(0, 2, (1, cfg.num_bits), generator=gen,
                             device=dev, dtype=torch.int32)
        job["x"] = chain.transmit(cfg, chain.loopback_taps(cfg), bits,
                                  generator=gen)[0].cpu()
        jobs[f"{cfg_name} sharded RX t{t}"] = job
    cfg_name, chunk_len, k, t = CARDS_STREAM
    streams, _ = make_streams(getattr(params, cfg_name), 1, k * chunk_len,
                              dev)
    jobs[f"{cfg_name} sharded stream t{t}, chunk {chunk_len} x {k}"] = dict(
        kind="reacq", cfg=cfg_name, t=t,
        chunks=streams[0].reshape(k, chunk_len).cpu())
    table, case, fo_range, cfo_hz, chunk_len, t = CARDS_LEGACY
    job = dict(kind="legacy", table=table, case=case, t=t, fo_range=fo_range,
               dsss=getattr(params, table)[case]["dsss"])
    k = -(-LEGACY_SAMPLES // chunk_len)
    stream, _ = make_legacy_stream(cards_config(job), k * chunk_len,
                                   job["dsss"], cfo_hz, dev)
    job["chunks"] = stream.reshape(k, chunk_len).cpu()
    jobs[f"{table[:-6]} case {case} sharded stream t{t} ({cfo_hz:+.0f} Hz, "
         f"chunk {chunk_len} x {k})"] = job
    cfg_name, batch, t = CARDS_CHAIN
    job = dict(kind="chain", cfg=cfg_name, t=t)
    cfg = cards_config(job)
    job["bits"] = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, 2, (batch, cfg.num_bits), dtype=np.int32))
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    n = cfg.frame_len + cfg.nfft - 1
    job["noise"] = torch.complex(
        torch.randn(batch, n, generator=gen, device=dev),
        torch.randn(batch, n, generator=gen, device=dev)).cpu()
    return jobs, {f"{cfg_name} dp x t{t} chain b{batch}": job}


def cards_path(job, mesh):
    """run() drives the job's path once on the mesh (a stream: a fresh
    receiver, ``push_many`` of every chunk and ``finish``) and returns its
    outputs by field."""
    from lte_gnu_radio_code_tpu_torch.parallel import chain as pchain
    from lte_gnu_radio_code_tpu_torch.parallel import sharded, streaming

    cfg, kind, dev = cards_config(job), job["kind"], mesh.device
    if kind == "rx":
        x = job["x"].to(dev)
        rx = sharded.make_sharded_rx(cfg, x.shape[-1], mesh)
        return lambda: rx(x)._asdict()
    if kind == "chain":
        step = pchain.make_sharded_chain(cfg, mesh)
        bits, noise = job["bits"].to(dev), job["noise"].to(dev)
        return lambda: dict(zip(("ber", "found", "lock"),
                                step(bits, noise=noise)))
    chunks = job["chunks"].to(dev)
    if kind == "reacq":
        def make():
            return streaming.ShardedReacqStreamingRx(cfg, chunks.shape[1],
                                                     mesh)
    else:
        def make():
            return streaming.ShardedLegacyStreamingRx(
                cfg, chunks.shape[1], mesh, fo_range=job["fo_range"],
                dsss=job["dsss"])

    def run():
        rx = make()
        return cat_outs([rx.push_many(chunks),
                         stack_outs(rx.finish())])._asdict()

    run.make = make
    return run


def cards_ms(run, reps, steps, barrier=None) -> tuple[float, list]:
    """Host ms a call or chunk step of run(), each of three rounds of reps
    runs ending in a synchronize (after a barrier, in a group): (the
    median, every round's)."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        if barrier is not None:
            barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / (reps * steps))
    return sorted(times)[1], times


@contextlib.contextmanager
def group_traffic():
    """The payload bytes this process hands ``torch.distributed`` inside
    the block (each all_reduce's and all_gather's own tensor, each send's)
    and the number of those calls."""
    import torch.distributed as dist

    sent = {"bytes": 0, "calls": 0}
    saved = (dist.all_reduce, dist.all_gather_into_tensor,
             dist.batch_isend_irecv)

    def add(n):
        sent["bytes"] += n
        sent["calls"] += 1

    def all_reduce(x, *args, **kw):
        add(x.nbytes)
        return saved[0](x, *args, **kw)

    def all_gather_into_tensor(out, x, *args, **kw):
        add(x.nbytes)
        return saved[1](out, x, *args, **kw)

    def batch_isend_irecv(ops):
        add(sum(o.tensor.nbytes for o in ops if o.op is dist.isend))
        return saved[2](ops)

    (dist.all_reduce, dist.all_gather_into_tensor,
     dist.batch_isend_irecv) = (all_reduce, all_gather_into_tensor,
                                batch_isend_irecv)
    try:
        yield sent
    finally:
        (dist.all_reduce, dist.all_gather_into_tensor,
         dist.batch_isend_irecv) = saved


def cards_gate(cfg, kind, steps, cell) -> None:
    """The launches a rank made on the main path, read from the counts:
    one K4 (on the rule's route) and one K2 a call or chunk step (the
    legacy receiver K2 alone), K1 and K3 too on the chain."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.kernels import sync_search

    counts, routes = kernels.launch_counts(), dict(sync_search.route_launches)
    want = {**dict.fromkeys(kernels.KERNEL_MODULES, 0), "equalize": steps,
            "sync_search": 0 if kind == "legacy" else steps}
    if kind == "chain":
        want.update(ofdm_mod=steps, channel_conv=steps)
    route = (None if kind == "legacy" else sync_search.route(
        cfg.nfft, cfg.cp_len, cfg.stride, cfg.m_synch))
    if counts != want or (route and routes[route] != steps):
        raise AssertionError(f"{cell}: {steps} calls or steps, launches "
                             f"{counts}, by route {routes} ({route} "
                             "expected)")


def cards_worker(pid: int, nproc: int, coord: str, jobs_path: str,
                 backend: str) -> None:
    """One process of ``cards_run``: "t" over CARDS_T_PROCS processes of
    its group (gloo: every process on cuda:0; NCCL: a card each).  For
    each job: a warm-up run, the main-path run with the launch counts set
    to 0 before it and gated after it (and the payload bytes handed to the
    group), three timed rounds, over NCCL one more chunk step under sync
    debug mode "error", and a run whose kernel inputs rank 0 holds K4 and
    K2 against their plain versions on.  Writes its results beside the
    jobs file."""
    import torch.distributed as dist
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.parallel import multihost

    multihost.init_distributed(coord, nproc, pid, backend=backend,
                               device="cuda:0" if backend == "gloo" else None)
    jobs = torch.load(jobs_path)
    results = {}
    for cell, job in jobs.items():
        mesh = multihost.multihost_mesh(t=job["t"], t_procs=CARDS_T_PROCS)
        cfg = cards_config(job)
        run = cards_path(job, mesh)
        run()                                           # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        kernels.reset_launch_counts()
        with group_traffic() as sent:
            out = run()
            torch.cuda.synchronize()
        counts = kernels.launch_counts()
        steps = out["valid"].shape[0] if "valid" in out else 1
        cards_gate(cfg, job["kind"], steps, f"{cell}: rank {pid}")
        if job["kind"] == "chain":
            out = dict(zip(out, multihost.gather_frames(mesh, *out.values())))
        ms, rounds = cards_ms(run, CARDS_REPS if steps == 1 else 1, steps,
                              dist.barrier)
        if backend == "nccl" and steps > 1:
            rx = run.make()
            rx.push(job["chunks"][0].to(mesh.device))
            no_host_sync(rx, job["chunks"][1].to(mesh.device),
                         f"{cell}: rank {pid}")
        with kernel_inputs() as seen:
            run()
        checks = (path_checks(cfg, seen, f"{cell} [rank 0 of {nproc}]",
                              step=min(1, steps - 1))
                  if pid == 0 and backend == "gloo" else None)
        dist.barrier()
        results[cell] = dict(out={k: v.cpu() for k, v in out.items()},
                             counts=counts, steps=steps, ms=ms, rounds=rounds,
                             sent=sent, checks=checks, mesh=dict(
                                 mesh.shape, t_local=mesh.t_local))
    torch.save(results, f"{jobs_path}.{pid}")
    dist.barrier()
    dist.destroy_process_group()
    print(f"CARDS_OK rank={pid} world={nproc} backend={backend} "
          f"t_procs={CARDS_T_PROCS} device={mesh.device}", flush=True)


def cards_spawn(jobs_path, nproc, backend) -> tuple[list, float]:
    """nproc worker processes of this script on the jobs file: each rank's
    results and the wall seconds, start-up included.  Fails where a worker
    exits nonzero, lacks its OK line or outlasts CARDS_TIMEOUT_S."""
    coord = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--cards-worker", str(pid), str(nproc),
         coord, str(jobs_path), backend], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(nproc)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=CARDS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for pid, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0 or f"CARDS_OK rank={pid} world={nproc}" \
                not in text:
            raise AssertionError(f"cards {backend} worker {pid} of {nproc}: "
                                 f"exit {p.returncode}, output:\n"
                                 f"{text[-4000:]}")
    for line in texts[0].splitlines():
        if ": sync_search " in line or ": equalize " in line:
            print("  " + line)
    # the workers' own files (their kernel rows hold numpy scalars)
    return [torch.load(f"{jobs_path}.{pid}", weights_only=False)
            for pid in range(nproc)], wall


def as_outs(d):
    """A dict of outputs as a NamedTuple, for :func:`same_outs`."""
    import collections
    return collections.namedtuple("Outs", d)(**d)


def cards_layout(jobs, tmp, backend, nproc, gpu, entries) -> float:
    """One spawn of ``cards_run`` and its gates: every rank's results ==
    this process's stacked run of the same mesh shape on the same buffers
    (integers exact, floats within 2e-4), every frame of the chain locked
    with BER 0; ms beside the stacked twin's, the payload bytes each rank
    hands the group.  Rank 0's kernel rows go into ``entries`` (gloo).
    Returns the spawn's wall seconds."""
    from lte_gnu_radio_code_tpu_torch.parallel import mesh

    path = tmp / f"{backend}{nproc}.pt"
    torch.save(jobs, path)
    ranks, wall = cards_spawn(path, nproc, backend)
    dp = nproc // CARDS_T_PROCS
    where = ("cuda:0" if backend == "gloo" else "a card each")
    for cell, job in jobs.items():
        t = job["t"]
        twin = cards_path(job, mesh.make_mesh(dp * t, dp=dp)
                          if job["kind"] == "chain" else mesh.time_mesh(t))
        ref = twin()
        torch.cuda.synchronize()
        first = ranks[0][cell]
        worst = max(same_outs(as_outs(r[cell]["out"]), as_outs(
            {k: v.cpu() for k, v in ref.items()}),
            f"{cell}: rank {i} of {nproc} ({backend}) vs the stacked run",
            float_atol=2e-4) for i, r in enumerate(ranks))
        if job["kind"] == "chain" and not (
                bool(ref["found"].all()) and float(ref["ber"].max()) == 0):
            raise AssertionError(f"{cell}: frames unlocked or BER above 0")
        steps = first["steps"]
        t_ms, t_rounds = cards_ms(twin, CARDS_REPS if steps == 1 else 1,
                                  steps)
        what = "a call" if steps == 1 else "a chunk step"
        label = (f"{cell} [{backend}: dp {dp} x \"t\" {t} over "
                 f"{CARDS_T_PROCS} processes of {first['mesh']['t_local']} "
                 f"shards, {where}]")
        sent = ", ".join(str(r[cell]["sent"]["bytes"] // steps)
                         for r in ranks)
        print(f"{label}: every rank == the stacked run (integer fields "
              f"equal, floats within {worst:.2e}); launches a rank "
              f"{first['counts']} in {steps} calls or steps; payload bytes "
              f"a rank hands the group {what}: {sent} in "
              f"{first['sent']['calls'] / steps:.1f} calls")
        print(f"{label}: {first['ms']:.3f} ms {what} (rounds "
              f"{', '.join(f'{v:.3f}' for v in first['rounds'])}); the "
              f"stacked twin {t_ms:.3f} (rounds "
              f"{', '.join(f'{v:.3f}' for v in t_rounds)}); group / stacked "
              f"{first['ms'] / t_ms:.3f}x, on {gpu}")
        for name, c in (first["checks"] or {}).items():
            entries.append(kernel_entry(name, f"{cell}, \"t\" over "
                                        f"{nproc} processes",
                                        first["counts"][name], c))
    return wall


def cards_run(dev, gpu, backends=("gloo", "nccl")) -> list:
    """"t" across processes (``multihost_mesh(t_procs=...)``).  Layout A,
    on this card: two worker processes of this script over gloo, "t" 4 as
    2 x 2 shards, on the sharded RX (CARDS_RX), the reacq stream and the
    CFO case 7 legacy stream; then four, dp 2 x t_procs 2, on the LTE1024
    b32 chain.  Layout B, where 2 cards or more are visible: the same over
    NCCL, one process a card (the chain at dp 2 on 4 cards, else dp 1),
    with a chunk step under sync debug mode "error".  ``backends`` names
    the layouts to run.  Returns the ``kernels`` line's entries (layout A's
    rank 0)."""
    jobs, chain_jobs = cards_jobs(dev)
    entries = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        if "gloo" in backends:
            wall = cards_layout(jobs, tmp, "gloo", CARDS_T_PROCS, gpu,
                                entries)
            wall += cards_layout(chain_jobs, tmp, "gloo", 2 * CARDS_T_PROCS,
                                 gpu, entries)
            print(f"cards gloo: the worker groups took {wall:.1f} s with "
                  f"start-up")
        if "nccl" not in backends:
            return entries
        n = torch.cuda.device_count()
        if n < 2:
            print(f"cards nccl: not run ({n} card visible)")
            return entries
        wall = cards_layout(jobs, tmp, "nccl", CARDS_T_PROCS, gpu, [])
        wall += cards_layout(chain_jobs, tmp, "nccl", min(
            n // CARDS_T_PROCS, 2) * CARDS_T_PROCS, gpu, [])
        print(f"cards nccl: {n} cards visible; the worker groups took "
              f"{wall:.1f} s with start-up")
    return entries


def kernel_entry(name, cell, launches, c) -> dict:
    """One entry of the ``kernels`` line: the main path's launch count and
    what :func:`compare` measured."""
    src, replaces = SOURCES[name]
    return {"name": f"{name} [{cell}]", "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            **{k: c[k] for k in ("kernel_route", "other_route_ms",
                                 "err_vs_float64", "err_vs_fft_plain",
                                 "surface_ms", "surface_max_ms")
               if k in c}}


def print_ptxas(log: str) -> None:
    """Each kernel's registers and spills (and any error) from the build
    log, under the kernel's (mangled) name."""
    name = ""
    for line in log.splitlines():
        if "entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas: ...{name[-44:]}: {line.strip()}")


def start():
    """The card and the kernels built from this checkout's sources, their
    registers printed: (device, the card's name and power limit), or None
    where torch sees no CUDA device."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return None
    from lte_gnu_radio_code_tpu_torch.kernels import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = card()
    print(f"card: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda};"
          f" {REPO}")
    t0 = time.perf_counter()
    _cuda.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    print_ptxas(_cuda.build_log())
    return torch.device("cuda"), gpu


def main() -> int:
    if (started := start()) is None:
        return 1
    from lte_gnu_radio_code_tpu_torch.utils import params

    dev, gpu = started
    route_cross_checks(dev)
    cli_check(dev)
    entries = []
    for cfg_name, batch in CELLS:
        cfg = getattr(params, cfg_name)
        cell = f"{cfg_name} b{batch}"
        checks = kernel_checks(cfg, batch, dev, cell)
        run = chain_run(cfg, batch, dev, cell)
        print(f"{cell}: {run['msps']:.3f} Msamples/s on {gpu}")
        for name, c in checks.items():
            entries.append(kernel_entry(name, cell, run["launches"][name], c))
    entries += k4_link_run(dev, gpu)
    for cfg_name, batch in LINK_CELLS:
        chain_graph_run(cfg_name, batch, dev, gpu)
    for cfg_name, batch, chunk_len, k in SERVING:
        cfg = getattr(params, cfg_name)
        cell = f"{cfg_name} serving b{batch}"
        counts, checks = serving_run(cfg, batch, chunk_len, k, dev, cell, gpu)
        for name, c in checks.items():
            entries.append(kernel_entry(name, cell, counts[name], c))
    for name, source, changes, batch, max_ber in QAM_CELLS:
        entries += qam_run(name, source, changes, batch, max_ber, dev, gpu)
    cfg_name, changes, batch, chunk_len, k, max_bit_err = SERVING_QAM
    cell = f"{cfg_name} {changes['modulation']} serving b{batch}"
    counts, checks = serving_run(config_of(cfg_name, changes), batch,
                                 chunk_len, k, dev, cell, gpu, max_bit_err)
    for name, c in checks.items():
        entries.append(kernel_entry(name, cell, counts[name], c))
    for i, (table, case, fo_range, cfo_hz) in enumerate(LEGACY):
        timed = (table, case) not in [c[:2] for c in LEGACY[:i]]
        cell, launches, check = legacy_run(table, case, fo_range, cfo_hz,
                                           dev, gpu, timed)
        if check is not None:
            entries.append(kernel_entry("equalize", cell, launches, check))
    split_check(dev)
    load_ms = dependent_load_ms(dev)
    entries += tracker_run(dev, gpu, load_ms)
    for c in TRACKER_LTE:
        entries += tracker_block_run(*c, dev, gpu, load_ms)
    entries += tracker_fill_run(dev, gpu, load_ms)
    for args in TRACKER_STREAMS:
        entries += tracker_stream_run(*args, dev, gpu, load_ms)
    entries += tracker_cell_run(dev, gpu, load_ms)
    for name, sdr_profile, batch in MIMO_CELLS:
        entries += mimo_run(name, sdr_profile, batch, dev, gpu)
    pls_run(dev, gpu)
    oracle_run(dev, gpu)
    cell, counts, checks = native_check(dev, gpu)
    for name, c in checks.items():
        entries.append(kernel_entry(name, cell, counts[name], c))
    entries += sharded_rx_run(dev, gpu)
    for cfg_name, batch, t in SHARDED_CHAIN:
        cell, counts, checks = sharded_chain_run(cfg_name, batch, t, dev, gpu)
        for name, c in checks.items():
            entries.append(kernel_entry(name, cell, counts[name], c))
    for cfg_name, chunk_len, k, t in SHARDED_STREAMS:
        cell, counts, checks = sharded_stream_run(cfg_name, chunk_len, k, t,
                                                  dev, gpu)
        for name, c in checks.items():
            entries.append(kernel_entry(name, cell, counts[name], c))
    for args in SHARDED_LEGACY:
        cell, launches, check = sharded_legacy_run(*args, dev, gpu)
        entries.append(kernel_entry("equalize", cell, launches, check))
    multihost_run(dev, gpu)
    entries += cards_run(dev, gpu)
    print(json.dumps({"kernels": entries}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def cards_main(backends) -> int:
    """``--cards [gloo|nccl]``: ``cards_run`` alone (one layout where it is
    named), with its gates, times and ``kernels`` entries: the way to run
    layout B on a host of several cards without the rest of the script."""
    if (started := start()) is None:
        return 1
    print(json.dumps({"kernels": cards_run(*started, backends)}))
    return 0


def tracker_block_main() -> int:
    """``--tracker-block``: the block route's main paths alone
    (TRACKER_LTE) and the l1k-track cell's receiver (TRACKER_CELL), with
    their gates, times and ``kernels`` entries.  A copy of this script in
    another commit's tree times that tree's kernel on the same inputs: the
    way to compare a change to the tracker's kernel with its parent in one
    call (parent, change, change, parent)."""
    if (started := start()) is None:
        return 1
    dev, gpu = started
    load_ms = dependent_load_ms(dev)
    entries = []
    for c in TRACKER_LTE:
        entries += tracker_block_run(*c, dev, gpu, load_ms)
    entries += tracker_cell_run(dev, gpu, load_ms)
    print(json.dumps({"kernels": entries}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tracker-block"]:
        sys.exit(tracker_block_main())
    elif sys.argv[1:2] == ["--multihost-worker"]:
        multihost_worker(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6])
    elif sys.argv[1:2] == ["--nccl-worker"]:
        nccl_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--cards-worker"]:
        cards_worker(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    elif sys.argv[1:2] == ["--cards"]:
        sys.exit(cards_main(sys.argv[2:3] or ("gloo", "nccl")))
    else:
        sys.exit(main())
