"""The tracking cell (``l1k-track``, ``entries/track.py``) and the 10 MHz
reacq cell (``l1k-live``) on the CPU at a tiny size: the check holds on the
program as it is, and comes out false with the TF32 control in the
program's place and with each fault planted in the timed path, the
parent's float32 pointer fit from a 2^28 base among them; the readers of
the tracker's spans and counters on synthetic traces; the scan's bytes
and operations by hand."""

from __future__ import annotations

import pytest
import torch

from ofdm_bench import harness
from ofdm_bench.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S
from lte_gnu_radio_code_tpu_torch.utils import profiling

SEED = 2 ** 31 + 5
LIVE_L1K = ("l1k-live", {"streams": 2, "rate_hz": 2.0, "ring_frames": 1})
TRACK = ("l1k-track", {"streams": 2, "chunk": 10240, "rate_hz": 3.0,
                       "ring_frames": 1})


def prepared(cell, overrides):
    run = harness.Run(cell, "cpu", overrides=overrides)
    run.spec["check"] = dict(run.spec["check"], check_steps=2,
                             check_answers=4)
    return run


@pytest.mark.parametrize("cell,overrides", [LIVE_L1K, TRACK],
                         ids=["live-l1k", "track"])
def test_program_as_it_is_is_correct(cell, overrides):
    run = prepared(cell, overrides)
    m = harness.measure(run, SEED, 1.0, False)
    assert m["tally"].checked >= 2 and m["tally"].correct, m["tally"].lines()
    assert m["attempted"] == m["win"]["steps"] * run.entry.answers_per_step


def test_control_in_the_programs_place_is_not_correct():
    m = harness.measure(prepared(*TRACK), SEED, 1.0, False, control=True)
    assert not m["tally"].correct
    lines = m["tally"].lines()
    assert lines["chan_gap"]["value"] > 3 * lines["chan_gap"]["limit"]
    assert lines["phasor_gap"]["value"] > lines["phasor_gap"]["limit"]


def _parent_fit():
    """The parent's pointer fit, float32 on global indices: b = (b0 at x
    = 0, b1) of the history read as float32, and ceil(b1 x + b0 - cp/4)
    at x = sym_count * pattern (4 here)."""
    def fit(hx, hy, n_eff, newest, pattern):
        w = (torch.arange(5) < n_eff[..., None]).to(torch.float32)
        x, y = hx.to(torch.float32), hy.to(torch.float32)
        s0, s1, s2 = w.sum(-1), (w * x).sum(-1), (w * x * x).sum(-1)
        sy, sxy = (w * y).sum(-1), (w * x * y).sum(-1)
        det = s0 * s2 - s1 * s1
        safe = det.abs() > 1e-9
        b1 = torch.where(safe, (s0 * sxy - s1 * sy) / torch.where(
            safe, det, torch.ones_like(det)), torch.zeros_like(det))
        b0 = torch.where(s0 > 0, (sy - b1 * s1) / s0.clamp_min(1.0),
                         torch.zeros_like(s0))
        return torch.stack([b0, b1], -1)

    def predict(hy, b, sym_count, cp):
        x = (sym_count * 4).to(torch.float32)
        return torch.ceil(b[:, 1] * x + b[:, 0] - cp / 4.0).to(torch.int32)

    return fit, predict


@pytest.mark.parametrize("how", ["answer", "half_batch", "pointer",
                                 "parent_fit"])
def test_track_faults_are_not_correct(monkeypatch, how):
    """The tracking cell's check refuses an altered answer (a bit of every
    detection, or one pointer moved by a sample with its delay kept), half
    the batch left out, and a program whose carry is the parent's: its
    pointer fit in float32 on global indices, run from global sample 2^28,
    where that fit loses the pattern grid."""
    from lte_gnu_radio_code_tpu_torch.models import tracker as trk
    from lte_gnu_radio_code_tpu_torch.runtime import stream
    run = prepared(*TRACK)
    if how == "parent_fit":
        fit, predict = _parent_fit()
        monkeypatch.setattr(trk, "_masked_lstsq", fit)
        monkeypatch.setattr(trk, "_predict", predict)
        run.entry.origin = 2 ** 28
    else:
        real = stream.track_stream_step

        def broken(cfg, state, chunk, *a, **k):
            new, out = real(cfg, state, chunk, *a, **k)
            if how == "answer":
                bits = out.hard_bits.clone()
                bits[..., 0, 3] ^= 1
                return new, out._replace(hard_bits=bits)
            if how == "pointer":
                return new, out._replace(ptrs=torch.where(
                    out.valid & (torch.arange(out.valid.shape[-1]) == 1),
                    out.ptrs + 1, out.ptrs))
            half = chunk.shape[0] // 2
            return new, type(out)(*(torch.cat([f[:half], f[:half]])
                                    for f in out))
        monkeypatch.setattr(stream, "track_stream_step", broken)
    m = harness.measure(run, SEED, 1.0, False)
    lines = m["tally"].lines()
    assert not m["tally"].correct
    assert lines["wrong_decisions"]["value"] > 0 or \
        lines["wrong_bits"]["value"] > 0


# -- the readers ----------------------------------------------------------------

def launch(t):
    return ("cudaLaunchKernel", t, t + 1)


def one_step(names, calls, device):
    """One chunk step of 100 us: its stages 20 us each in turn from 0."""
    host = [("ofdm.chunk_step", 0, 100)] + [
        (n, 20 * i, 20 * (i + 1)) for i, n in enumerate(names)]
    return dict(host=host + [launch(t) for t in calls], device=device,
                launch_calls=len(calls), steps=1)


TRACK_METRICS = ["track_host_ms.live", "track_device_ms.live"]


def test_tracker_stage_metrics_read_the_track_span():
    live = one_step(["ofdm.track", "ofdm.select", "ofdm.demod",
                     "ofdm.decide"], [5, 10, 50],
                    [("cat", 5, 9), ("tracker_scan_kernel", 10, 16),
                     ("gemm", 55, 75)])
    read = {n: harness.metric_module(n).read({"trace": live})
            for n in TRACK_METRICS}
    assert read == pytest.approx({"track_host_ms.live": 0.020,
                                  "track_device_ms.live": 0.010})
    parent = [x for x in live["host"] if not x[0].startswith("ofdm.")]
    for n in TRACK_METRICS:
        assert harness.metric_module(n).read(
            {"trace": dict(live, host=parent)}) is None


def _fired(values):
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for v in values:
            profiling.count("ofdm.fired", torch.tensor(v))


def test_tracker_step_us_is_the_scan_time_over_the_slowest_stream():
    """Two traced steps, 27 and 29 steps computed by their slowest stream,
    the scan kernels 140 us a step: 5 us a dependent step."""
    tr = {"steps": 2, "device": [
        ("void (anonymous namespace)::tracker_scan_kernel<1024>(Params)",
         0.0, 130.0),
        ("void (anonymous namespace)::tracker_scan_kernel<1024>(Params)",
         500.0, 650.0), ("equalize_fft_kernel<1024>", 700.0, 900.0)]}
    read = harness.metric_module("tracker_step_us.live").read
    _fired([[27, 26, 27], [28, 29, 28]])
    try:
        assert read({"trace": tr}) == pytest.approx(140.0 / 28.0)
        assert read({"trace": dict(tr, device=tr["device"][2:])}) is None
    finally:
        profiling.reset_counters()
    assert read({"trace": tr}) is None                  # no counter kept


def test_tracker_metrics_of_a_program_without_the_counter(monkeypatch):
    tr = {"steps": 1, "device": [("tracker_scan_kernel", 0.0, 100.0)]}
    monkeypatch.delattr(profiling, "kept")
    monkeypatch.delattr(profiling, "counters")
    for n in ("tracker_step_us.live", "tracker_roofline.live"):
        assert harness.metric_module(n).read({"trace": tr, "k4": {}}) is None


# the l1k-track cell's scan: B 16, ext = the tracker's lag (a pattern's
# reach, nfft and 2 cp) + the chunk, 1,028 slots, det_max 87
TRACK_SHAPE = dict(batch=16, n=(4 * 1280 + 1024 + 2 * 256) + 131072,
                   nfft=1024, cp=256, m_synch=1, num_synch_bins=1022,
                   rx_b_len=1280, steps=131072 // 128 + 4,
                   max_det=131072 // (2 * 256 + 1024) + 2)


def test_tracker_counts_by_hand():
    """Per computed step one forward and one inverse 1024-point transform
    (5 N log2 N each), 24 operations a synch bin and 3 a delay; the bytes
    the windows read (8 a sample), the carry twice (72 bytes a stream), 13
    bytes a slot and the channel table."""
    tr = vars(harness.metric_module("tracker_roofline.live"))
    computed = 16 * 27.0
    ops = computed * (2 * 5 * 1024 * 10 + 24 * 1022 + 3 * 257)
    assert tr["tracker_ops"](computed, **TRACK_SHAPE) == ops
    nbytes = (computed * 1024 * 8 + 2 * 16 * 72 + 16 * 1028 * 13 +
              16 * 87 * 1024 * 8)
    assert tr["tracker_bytes"](computed, **TRACK_SHAPE) == nbytes
    assert tr["tracker_least_s"](computed, TRACK_SHAPE) == pytest.approx(
        max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S), rel=1e-12)


def test_track_entry_hands_the_roofline_its_shape():
    spec = harness.cell_spec("l1k-track")
    from ofdm_bench.entries import track
    entry = track.Entry(spec["config"], spec["traffic"], torch.device("cpu"))
    entry.make_inputs(3)
    assert entry.k4_shape() == TRACK_SHAPE


def test_l1k_live_hands_k4_its_shape():
    """K4 at l1k-live: the reacq lag (21 strides of 255) and the chunk,
    256 trials of nfft 1024."""
    spec = harness.cell_spec("l1k-live")
    from ofdm_bench.entries import reacq
    entry = reacq.Entry(spec["config"], spec["traffic"], torch.device("cpu"))
    assert entry.k4_shape() == dict(batch=16, n=21 * 255 + 65280,
                                    n_trials=256, nfft=1024, cp=256,
                                    m_synch=1)


def test_tracker_roofline_reads_the_scan_kernels_and_the_counter():
    tr = vars(harness.metric_module("tracker_roofline.live"))
    least = tr["tracker_least_s"](16 * 27.5, TRACK_SHAPE)
    trace = {"steps": 2, "device": [
        ("void (anonymous namespace)::tracker_scan_kernel<1024>(Params)",
         0.0, 4 * least * 1e6),
        ("void (anonymous namespace)::equalize_fft_kernel<1024>", 0.0, 9.0)]}
    _fired([[27] * 16, [28] * 16])
    try:
        assert tr["read"]({"trace": trace, "k4": TRACK_SHAPE}) == \
            pytest.approx(50.0)
        trace["device"] = trace["device"][1:]
        assert tr["read"]({"trace": trace, "k4": TRACK_SHAPE}) is None
    finally:
        profiling.reset_counters()
