"""The port's stage spans and counters (``utils/profiling.py``) in its
benchmarked steps, on the CPU: ``models/chain.py:chain_batch``,
``runtime/stream.py:BatchReacqStreamingRx.push``,
``BatchTrackerStreamingRx.push`` and the 2x2 SpMult chain step
(``models/mimo.py:make_mimo_chain``).

Under ``torch.profiler`` every stage span of a step appears once a step,
inside its root span, in the step's order; with the profiler off no
``record_function`` is entered; outputs are bit-identical either way; the
counters hold what the step computed; ``trace`` writes them beside its
Chrome trace."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from lte_gnu_radio_code_tpu_torch.models import chain, mimo, rxofdm, txofdm
from lte_gnu_radio_code_tpu_torch.ops import channel
from lte_gnu_radio_code_tpu_torch.runtime import stream as rt
from lte_gnu_radio_code_tpu_torch.utils import profiling
from lte_gnu_radio_code_tpu_torch.utils.params import GOLDEN64

CFG = dataclasses.replace(GOLDEN64, num_ofdm_symb=24)
CHUNK, STREAMS, STEPS = 4800, 2, 3
STAGES = {
    "chain": ("ofdm.chain_step", ["ofdm.tx", "ofdm.search", "ofdm.lock",
                                  "ofdm.demod", "ofdm.demap"]),
    "stream": ("ofdm.chunk_step", ["ofdm.search", "ofdm.select",
                                   "ofdm.demod", "ofdm.decide"]),
    "track": ("ofdm.chunk_step", ["ofdm.track", "ofdm.select",
                                  "ofdm.demod", "ofdm.decide"]),
    "mimo": ("ofdm.chain_step", ["ofdm.tx", "ofdm.search", "ofdm.lock",
                                 "ofdm.estimate", "ofdm.demod",
                                 "ofdm.detect", "ofdm.demap"]),
}
MIMO_CFG = dataclasses.replace(GOLDEN64, synch_dat=(2, 6), num_ofdm_symb=16,
                               num_ant_txrx=2, snr_db=20.0)


@pytest.fixture(autouse=True)
def empty_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _chain_inputs():
    """(h, n_trials, num_patterns, bits [STEPS, 2, num_bits], noise
    [STEPS, 2, n]): STEPS steps of 2 frames of fixed bits and noise."""
    n = CFG.frame_len + CFG.nfft - 1
    n_trials, num_patterns = rxofdm.plan_rx(CFG, n)
    rng = np.random.default_rng(3)
    bits = torch.from_numpy(rng.integers(0, 2, (STEPS, 2, CFG.num_bits),
                                         dtype=np.int32))
    noise = torch.from_numpy((rng.standard_normal((STEPS, 2, n)) + 1j *
                              rng.standard_normal((STEPS, 2, n))
                              ).astype(np.complex64))
    return chain.loopback_taps(CFG), n_trials, num_patterns, bits, noise


def _chain_steps():
    """STEPS chain_batch steps of 2 frames at 20 dB on fixed noise."""
    h, n_trials, num_patterns, bits, noise = _chain_inputs()
    return [chain.chain_batch(CFG, h, n_trials, num_patterns, bits[i],
                              noise=noise[i]) for i in range(STEPS)]


def _streams():
    """[STEPS, STREAMS, CHUNK] chunks of continuous faded streams."""
    n = STEPS * CHUNK
    frames = -(-n // GOLDEN64.frame_len)
    bits = torch.from_numpy(np.random.default_rng(5).integers(
        0, 2, (STREAMS * frames, GOLDEN64.num_bits), dtype=np.int32))
    tx = txofdm.tx_frames(GOLDEN64, bits).reshape(STREAMS, -1)
    x = channel.apply_channel(tx, chain.loopback_taps(GOLDEN64),
                              max_impulse=GOLDEN64.nfft)[:, :n]
    return x.reshape(STREAMS, STEPS, CHUNK).transpose(0, 1).contiguous()


CHUNKS = _streams()


def _stream_steps():
    rx = rt.BatchReacqStreamingRx(GOLDEN64, CHUNK, STREAMS, device="cpu")
    return [rx.push(c) for c in CHUNKS]


TRACK_CHUNK = 800       # the plain tracker steps one stride at a time
TRACK_CHUNKS = CHUNKS.transpose(0, 1).reshape(STREAMS, -1)[
    :, :STEPS * TRACK_CHUNK].reshape(STREAMS, STEPS, TRACK_CHUNK).transpose(
        0, 1).contiguous()


def _tracker():
    return rt.BatchTrackerStreamingRx(GOLDEN64, TRACK_CHUNK, STREAMS,
                                      device="cpu")


def _track_steps():
    rx = _tracker()
    return [rx.push(c) for c in TRACK_CHUNKS]


def _mimo_steps():
    """STEPS 2x2 SpMult chain steps of 2 frames at 20 dB on fixed bits
    and noise, 16 symbols (two (2, 6) patterns) a frame."""
    n = MIMO_CFG.frame_len + MIMO_CFG.nfft - 1
    rng = np.random.default_rng(4)
    bits = torch.from_numpy(rng.integers(0, 2, (STEPS, 2, 2,
                                                MIMO_CFG.num_bits),
                                         dtype=np.int32))
    noise = torch.from_numpy((rng.standard_normal((STEPS, 2, 2, n)) + 1j *
                              rng.standard_normal((STEPS, 2, 2, n))
                              ).astype(np.complex64))
    step = mimo.make_mimo_chain(MIMO_CFG, device="cpu")
    return [step(bits[i], noise=noise[i]) for i in range(STEPS)]


RUN = {"chain": _chain_steps, "stream": _stream_steps, "track": _track_steps,
       "mimo": _mimo_steps}
KINDS = pytest.mark.parametrize("kind", ["chain", "stream", "track", "mimo"])


def _ofdm_spans(prof):
    return sorted((e.time_range.start, -e.time_range.end, e.name)
                  for e in prof.events() if e.name.startswith("ofdm."))


@KINDS
def test_stage_spans_nest_under_their_root_in_order(kind):
    root, stages = STAGES[kind]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        RUN[kind]()
    spans = [(s, -neg_e, name) for s, neg_e, name in _ofdm_spans(prof)]
    roots = [sp for sp in spans if sp[2] == root]
    assert len(roots) == STEPS
    assert len(spans) == STEPS * (1 + len(stages))
    for s0, e0, _ in roots:
        inside = [name for s, e, name in spans
                  if s0 <= s and e <= e0 and name != root]
        assert inside == stages


@KINDS
def test_no_record_function_with_the_profiler_off(kind, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    RUN[kind]()
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        RUN[kind]()
    root, stages = STAGES[kind]
    assert len(entered) == STEPS * (1 + len(stages))
    assert set(entered) == {root, *stages}


@KINDS
def test_outputs_bit_identical_with_the_profiler_on_and_off(kind):
    off = RUN[kind]()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = RUN[kind]()
    for a, b in zip(off, on):
        for name in a._fields:
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert torch.equal(x.contiguous().view(torch.uint8),
                               y.contiguous().view(torch.uint8)), name


def test_detection_and_slot_counters_hold_the_steps_values():
    outs = _stream_steps()                 # profiler off: nothing is kept
    assert profiling.counters() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        outs = _stream_steps()
    det_max = rt.reacq_det_max(GOLDEN64, CHUNK)
    found = sum(int(o.valid.sum()) for o in outs)
    assert found > 0
    assert profiling.counters() == {
        "ofdm.detections": (found, STEPS),
        "ofdm.slots": (STEPS * STREAMS * det_max, STEPS),
        "ofdm.graph_steps": (0, STEPS)}          # the CPU steps eagerly


def test_tracker_counters_hold_the_steps_values():
    """The tracker's chunk step keeps the table's count, streams x det_max
    and, in ``ofdm.fired``, the steps its scan computed a stream: the loop
    count's growth and the one step that did not fire (whose outputs fill
    the call's remaining slots), as ``kept`` lists them."""
    rx = _tracker()
    loops = [rx.state.carry.loop_count.clone()]
    outs = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for c in TRACK_CHUNKS:
            outs.append(rx.push(c))
            loops.append(rx.state.carry.loop_count.clone())
    fired = [torch.clamp(b - a + 1, max=rx.slots)
             for a, b in zip(loops, loops[1:])]
    found = sum(int(o.valid.sum()) for o in outs)
    assert found > 0 and all(bool((f < rx.slots).all()) for f in fired)
    assert profiling.counters() == {
        "ofdm.detections": (found, STEPS),
        "ofdm.slots": (STEPS * STREAMS * rx.det_max, STEPS),
        "ofdm.fired": (int(sum(f.sum() for f in fired)), STEPS)}
    kept = profiling.kept("ofdm.fired")
    assert len(kept) == STEPS
    for a, b in zip(kept, fired):
        assert torch.equal(a, b)
    assert profiling.kept("ofdm.nothing") == []


def test_mimo_detect_frames_counter_holds_the_steps_frames():
    """The 2x2 step keeps ``ofdm.detect_frames``, its frame count, once a
    step while the profiler records, and nothing with it off."""
    outs = _mimo_steps()
    assert profiling.counters() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        outs = _mimo_steps()
    assert bool(torch.stack([o.found for o in outs]).all())
    assert profiling.counters() == {"ofdm.detect_frames": (STEPS * 2, STEPS)}
    assert profiling.kept("ofdm.detect_frames") == [2] * STEPS


def test_counters_sum_host_ints_and_device_values():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("a", 3)
        profiling.count("a", torch.tensor([1, 2], dtype=torch.int32))
        profiling.count("b", torch.tensor(4))
    profiling.count("a", 100)              # profiler off: not kept
    assert profiling.counters() == {"a": (6, 2), "b": (4, 1)}
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_trace_resets_the_counters_and_writes_them_beside_the_trace(
        tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("ofdm.slots", 999)
    with profiling.trace(tmp_path):
        outs = _stream_steps()
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    stem = traces[0].name[:-len(".pt.trace.json")]
    got = json.loads((tmp_path / f"{stem}.counters.json").read_text())
    det_max = rt.reacq_det_max(GOLDEN64, CHUNK)
    assert got == {
        "ofdm.detections": {"total": sum(int(o.valid.sum()) for o in outs),
                            "records": STEPS},
        "ofdm.slots": {"total": STEPS * STREAMS * det_max,
                       "records": STEPS},
        "ofdm.graph_steps": {"total": 0, "records": STEPS}}
    names = {e.get("name") for e in json.loads(
        traces[0].read_text())["traceEvents"]}
    assert {"ofdm.chunk_step", "ofdm.search", "ofdm.decide"} <= names


def test_the_gate_is_torchs_profiler_flag():
    """span and count read ``torch.autograd.profiler._is_profiler_enabled``,
    which a torch.profiler session sets while it records; this fails if
    torch moves or renames it."""
    assert autograd_profiler._is_profiler_enabled is False
    assert profiling.span("ofdm.x") is profiling.span("ofdm.y")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert isinstance(profiling.span("ofdm.x"),
                          torch.profiler.record_function)
    assert autograd_profiler._is_profiler_enabled is False


def test_chain_steps_on_the_cpu_run_the_eager_body():
    """``chain_batch`` on CPU tensors given ``noise=`` replays no graph:
    under the profiler ``ofdm.graph_steps`` keeps 0 a step, no graph is
    cached, and each step's outputs are the eager body's bit for bit."""
    graphs = len(chain._graphs)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        outs = _chain_steps()
    assert profiling.kept("ofdm.graph_steps") == [0] * STEPS
    assert len(chain._graphs) == graphs
    h, n_trials, num_patterns, bits, noise = _chain_inputs()
    for i, out in enumerate(outs):
        ref = chain._chain_batch_eager(CFG, h, n_trials, num_patterns,
                                       bits[i], noise=noise[i])
        for name in out._fields:
            x, y = getattr(out, name), getattr(ref, name)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert torch.equal(x.contiguous().view(torch.uint8),
                               y.contiguous().view(torch.uint8)), name


KEY_CHANGES = {
    "snr_db": lambda a: dict(a, cfg=dataclasses.replace(
        CFG, snr_db=CFG.snr_db + 1.0)),
    "taps": lambda a: dict(a, h=a["h"] * np.complex64(1j)),
    "tap_count": lambda a: dict(a, h=np.concatenate(
        [a["h"], np.zeros(1, a["h"].dtype)])),
    "tap_dtype": lambda a: dict(a, h=a["h"].astype(np.complex128)),
    "plan": lambda a: dict(a, num_patterns=a["num_patterns"] - 1),
    "batch": lambda a: dict(a, bits=a["bits"][:1], noise=a["noise"][:1]),
    "noise_dtype": lambda a: dict(
        a, noise=a["noise"].to(torch.complex128)),
}


@pytest.mark.parametrize("change", sorted(KEY_CHANGES))
def test_the_chain_graph_key_tells_steps_apart(change):
    """Two steps whose graphs would differ have different keys: two
    configurations that differ only in ``snr_db`` (which AWGN and the
    channel estimate read as Python floats), two taps arrays (values,
    length or dtype), plans, batches or noise dtypes; equal arguments
    (the taps a copy) give one key.  Only a new input shape or dtype
    changes the key's last entry, which names the shared buffers."""
    h, n_trials, num_patterns, bits, noise = _chain_inputs()
    args = dict(cfg=CFG, h=h, n_trials=n_trials, num_patterns=num_patterns,
                bits=bits[0], noise=noise[0])
    key = chain._graph_key(**args)
    assert chain._graph_key(**dict(args, h=h.copy())) == key
    other = chain._graph_key(**KEY_CHANGES[change](args))
    assert other != key
    assert (other[-1] != key[-1]) == (change in ("batch", "noise_dtype"))
