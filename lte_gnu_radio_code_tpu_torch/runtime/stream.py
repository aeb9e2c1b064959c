"""Streaming runtime in torch: a chunked sample stream drives one step
function with an explicit carry,

    state_{t+1}, out_t = step(state_t, chunk_t)

Port of ``lte_gnu_radio_code_tpu/runtime/stream.py``: the single-lock
stream (``hist_len_for``, ``StreamState``, ``ChunkOut``, ``init_state``,
``stream_step``, ``StreamingRx``) and the continuous multi-detection one
(``reacq_lag``, ``reacq_det_max``, ``ReacqState``, ``ReacqChunkOut``,
``reacq_init``, ``reacq_step``, ``ReacqStreamingRx``,
``BatchReacqStreamingRx``) and the legacy CFO/DSSS one (``legacy_lag``,
``LegacyStreamState``, ``LegacyChunkOut``, ``legacy_init``,
``legacy_stream_step``, ``LegacyStreamingRx``), with ``push``,
``push_many``, ``finish`` and npz checkpoints whose keys are the JAX
receivers', so a checkpoint written by either package resumes in the
other; and the streaming tracker (``tracker_lag``, ``TrackStreamState``,
``TrackChunkOut``, ``track_stream_init``, ``track_stream_step``,
``TrackerStreamingRx``, with ``push``, ``push_many`` and ``finish``; it has
no checkpoints, as the JAX one has none), which here also serves many
streams at once (``BatchTrackerStreamingRx``, whose B = 1 case
``TrackerStreamingRx`` is).  The receivers serve every
modulation the demap knows (``models/stream_rx.py:hard_decide``).

A step keeps static shapes (fixed [det_max] / [kmax] tables with a
``valid`` mask), holds its carry in device tensors and never waits for the
host: no ``.item()``, no boolean-mask indexing, no tensor made from a
Python number on the way.  That is what lets a step be captured in a CUDA
graph, as ``ReacqStreamingRx`` does on a CUDA device: it replays one
graph a full chunk.  The batch receiver's step carries an explicit leading
stream axis: one sync search (K4) and one demod (K2) launch a chunk step,
however many streams there are.  The tracker's step is one launch of its
step loop (``kernels/tracker.py``) and one of K2, however many streams
there are.

The receivers run on the CUDA device unless the caller passes a ``device``
(``"cpu"`` runs the kernels' plain twins); where there is no CUDA device
and none is passed they raise.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..kernels import equalize
from ..kernels import tracker as tracker_kernel
from ..models import legacy_rx, stream_rx, tracker
from ..ops import cfo as cfo_ops
from ..ops import sync
from ..utils import profiling
from ..utils.device import as_samples, resolve_device
from ..utils.params import OFDMConfig
from ..utils.tables import device_table


class StreamState(NamedTuple):
    hist: torch.Tensor          # [hist_len] trailing samples of past chunks
    base: torch.Tensor          # global sample index of the next chunk
    locked: torch.Tensor        # bool: the single-lock flag
    lock_ptr: torch.Tensor      # global lock pointer
    delay_idx: torch.Tensor
    chan_full: torch.Tensor     # [nfft] locked channel estimate
    next_k: torch.Tensor        # next pattern block to demodulate
    last_det_ptr: torch.Tensor  # refractory reference across chunks


class ChunkOut(NamedTuple):
    phasors: torch.Tensor       # [kmax, nd, num_data_bins]
    block_ids: torch.Tensor     # [kmax] global pattern-block index, or -1
    valid: torch.Tensor         # [kmax] bool
    found: torch.Tensor         # bool: locked as of the end of this chunk
    lock_ptr: torch.Tensor


def hist_len_for(cfg: OFDMConfig) -> int:
    """The longest reach of a window beyond a trial or block start."""
    sync_reach = cfg.cp_len + cfg.m_synch * cfg.rx_b_len + cfg.nfft
    data_reach = cfg.pattern_len * cfg.rx_b_len + cfg.nfft
    return max(sync_reach, data_reach)


def _scalar(value, dtype, device, batch=None) -> torch.Tensor:
    return torch.full(() if batch is None else (batch,), value, dtype=dtype,
                      device=device)


def init_state(cfg: OFDMConfig, chunk_len: int, device=None) -> StreamState:
    device = resolve_device(device)
    i32 = functools.partial(_scalar, 0, torch.int32, device)
    return StreamState(
        hist=torch.zeros(hist_len_for(cfg), dtype=torch.complex64,
                         device=device),
        base=i32(), locked=_scalar(False, torch.bool, device),
        lock_ptr=i32(), delay_idx=i32(),
        chan_full=torch.zeros(cfg.nfft, dtype=torch.complex64, device=device),
        next_k=i32(), last_det_ptr=i32())


def _stride_aligned(cfg: OFDMConfig, chunk_len: int) -> int:
    stride = max(1, cfg.stride)
    if chunk_len % stride:
        raise ValueError(f"chunk length {chunk_len} is not a multiple of "
                         f"the sync stride {stride}")
    return stride


def stream_step(cfg: OFDMConfig, state: StreamState, chunk: torch.Tensor,
                num_patterns_total: int) -> tuple[StreamState, ChunkOut]:
    """One chunk of the single-lock stream (``stream.py:stream_step``): the
    first un-refractory gate crossing locks, and every pattern block that
    has become readable is demodulated with the lock's channel estimate:
    the search is K4, the demod K2 (``models/stream_rx.py``)."""
    chunk_len = chunk.shape[0]
    stride = _stride_aligned(cfg, chunk_len)
    hist_len = hist_len_for(cfg)
    dev = chunk.device
    ext = torch.cat([state.hist, chunk])       # covers [base-hist, base+chunk)
    ext_start = state.base - hist_len          # global coordinate of ext[0]

    # -- the trials that became fully readable with this chunk --------------
    t_per = chunk_len // stride
    dmax_val, dmax_ind = stream_rx.detect_trials(cfg, ext, t_per)
    global_ptrs = ext_start + cfg.cp_len + cfg.stride * torch.arange(
        t_per, device=dev)
    # the batch RX evaluates no trial before cp: mask them, so that the
    # stream locks where it does
    crossing = (dmax_val > sync.gate_level(cfg)) & (global_ptrs >= cfg.cp_len)
    ok = crossing & ((global_ptrs - state.last_det_ptr >
                      2 * cfg.cp_len + cfg.nfft) | (state.last_det_ptr == 0))
    any_new = ok.any() & ~state.locked
    first_j = ok.to(torch.int32).argmax()[None]        # first True (0 if none)
    new_lock_ptr = global_ptrs.gather(0, first_j)[0]
    new_delay = dmax_ind.gather(0, first_j)[0]
    spec = sync.sync_spectrum_at(cfg, ext, first_j[0])
    _, new_chan, _ = sync.estimate_channel(cfg, spec, new_delay)

    locked = state.locked | any_new
    lock_ptr = torch.where(any_new, new_lock_ptr, state.lock_ptr)
    delay_idx = torch.where(any_new, new_delay, state.delay_idx)
    chan_full = torch.where(any_new, new_chan, state.chan_full)
    last_det = torch.where(any_new, new_lock_ptr, state.last_det_ptr)

    # -- data demod: the pattern blocks whose whole window lies in ext ------
    m0, nd = cfg.m_synch, cfg.synch_dat[1]
    block = cfg.pattern_len * cfg.rx_b_len
    kmax = chunk_len // block + 2
    k0 = torch.where(locked & ~any_new, state.next_k, 0)
    k = k0 + torch.arange(kmax, device=dev)
    b_k = lock_ptr + k * block
    last_need = b_k + (m0 + nd - 1) * cfg.rx_b_len + cfg.nfft
    readable = (last_need <= state.base + chunk_len) & (b_k >= ext_start)
    valid = locked & readable & (k < num_patterns_total)
    rel = torch.where(valid, b_k - ext_start, 0)
    win = sync.windows_at(ext, rel, device_table(
        sync.data_window_offsets, dev, cfg, 1))             # [kmax, nd, nfft]
    coeff = equalize.combined_coeff(cfg, delay_idx, chan_full)
    phasors = stream_rx.demod_rows(cfg, win, coeff) * valid[:, None, None]
    next_k = torch.where(locked, k0 + valid.sum(), 0)

    i32 = torch.int32
    new_state = StreamState(
        hist=ext[-hist_len:].clone(), base=state.base + chunk_len,
        locked=locked, lock_ptr=lock_ptr.to(i32), delay_idx=delay_idx.to(i32),
        chan_full=chan_full, next_k=next_k.to(i32),
        last_det_ptr=last_det.to(i32))
    out = ChunkOut(phasors=phasors,
                   block_ids=torch.where(valid, k, -1).to(i32), valid=valid,
                   found=locked, lock_ptr=new_state.lock_ptr)
    return new_state, out


# ---------------------------------------------------------------------------
# Continuous multi-detection streaming (the receiver the reference's
# loopback app runs forever)
# ---------------------------------------------------------------------------
#
# Per chunk the receiver searches, accepts every un-refractory gate crossing,
# refreshes the channel estimate per detection and demodulates each
# detection's pattern block with its own estimate.  The carry is small:
#
#   hist      the trailing `lag` samples, sized so that every trial processed
#             in a chunk has its whole reach (sync windows and its pattern
#             block's data symbols) inside ext = [hist, chunk].  Trials are
#             processed `lag` samples behind the newest input, and every
#             detection is emitted once, with its demod complete.
#   last_det_ptr / any_det   the refractory rule's carry, so that detections
#             are accepted as by one scan over the whole stream.
#
# Chunked output == rx_detections on the concatenated stream.


def reacq_lag(cfg: OFDMConfig) -> int:
    """History length: cp + a trial's longest reach (its last data symbol),
    rounded up to a stride multiple so that chunk trial grids stay aligned."""
    need = cfg.cp_len + (cfg.pattern_len - 1) * cfg.rx_b_len + cfg.nfft
    s = max(1, cfg.stride)
    return -(-need // s) * s


def reacq_det_max(cfg: OFDMConfig, chunk_len: int) -> int:
    """Upper bound on a chunk's detections under the refractory rule."""
    return chunk_len // (2 * cfg.cp_len + cfg.nfft) + 1


class ReacqState(NamedTuple):
    hist: torch.Tensor          # [..., lag] trailing samples
    base: torch.Tensor          # [...] global index of the next chunk's start
    real_end: torch.Tensor      # [...] global count of real (unpadded) samples
    last_det_ptr: torch.Tensor  # [...]
    any_det: torch.Tensor       # [...] bool


class ReacqChunkOut(NamedTuple):
    ptrs: torch.Tensor       # [..., det_max] global detection pointers, or -1
    delays: torch.Tensor     # [..., det_max]
    peaks: torch.Tensor      # [..., det_max]
    valid: torch.Tensor      # [..., det_max] bool
    demod_ok: torch.Tensor   # [..., det_max] bool: data window in real samples
    chans: torch.Tensor      # [..., det_max, nfft] per-detection channel
    phasors: torch.Tensor    # [..., det_max, nd, num_data_bins]
    hard_bits: torch.Tensor  # [..., det_max, nd, num_data_bins*bits_per_bin]


def reacq_init(cfg: OFDMConfig, device=None,
               batch: int | None = None) -> ReacqState:
    """The empty carry of one stream, or of ``batch`` streams with a leading
    stream axis on every field."""
    device = resolve_device(device)
    lead = () if batch is None else (batch,)
    i32 = functools.partial(_scalar, 0, torch.int32, device, batch)
    return ReacqState(
        hist=torch.zeros(*lead, reacq_lag(cfg), dtype=torch.complex64,
                         device=device),
        base=i32(), real_end=i32(), last_det_ptr=i32(),
        any_det=_scalar(False, torch.bool, device, batch))


def reacq_step(cfg: OFDMConfig, state: ReacqState, chunk: torch.Tensor,
               n_real, det_max: int) -> tuple[ReacqState, ReacqChunkOut]:
    """One chunk of the continuous multi-detection receiver
    (``stream.py:reacq_step``), of one stream (chunk [chunk_len]) or of
    many at once (chunk [B, chunk_len], every state field with a leading
    B; ``n_real``, the chunk's real samples, is one number for all).

    Processes the chunk_len // stride trials whose pointers fall in
    [base - lag + cp, base - lag + cp + chunk_len), so that each trial's
    whole pattern reach is readable in ext = [hist, chunk]; the refractory
    rule continues across chunks through (last_det_ptr, any_det).  ext is
    one new contiguous tensor a step (K4 reads its rows by 8-byte copies)
    and the new history a copy of its tail, not a view that would keep it
    alive.

    Spans ``ofdm.search``, ``ofdm.select``, ``ofdm.demod``,
    ``ofdm.decide``; counters ``ofdm.detections`` (the table's count) and
    ``ofdm.slots`` (streams x det_max)."""
    new_state, out, count = _reacq_stages(cfg, state, chunk, n_real,
                                          det_max)
    profiling.count("ofdm.detections", count)
    profiling.count("ofdm.slots", det_max * count.numel())
    return new_state, out


def _reacq_stages(cfg: OFDMConfig, state: ReacqState, chunk: torch.Tensor,
                  n_real, det_max: int
                  ) -> tuple[ReacqState, ReacqChunkOut, torch.Tensor]:
    """:func:`reacq_step` without its counters: (new state, outputs, the
    table's count [...]), the work a receiver captures in a CUDA graph."""
    chunk_len = chunk.shape[-1]
    stride = _stride_aligned(cfg, chunk_len)
    lag = reacq_lag(cfg)
    dev = chunk.device
    with profiling.span("ofdm.search"):
        ext = torch.cat([state.hist, chunk], -1)
        ext_start = state.base - lag   # global coordinate of ext[..., 0]

        t_per = chunk_len // stride
        dmax_val, dmax_ind = stream_rx.detect_trials(cfg, ext, t_per)
        local_ptrs = cfg.cp_len + stride * torch.arange(t_per, device=dev)
        global_ptrs = ext_start[..., None] + local_ptrs
        # trials before the stream's head (chunk 0's warm-up region) do not
        # exist
        crossing = ((dmax_val > sync.gate_level(cfg)) &
                    (global_ptrs >= cfg.cp_len))

    with profiling.span("ofdm.select"):
        g_ptrs, (l_ptrs, delays, peaks), count, (last_ptr, any_det) = \
            sync.refractory_table(
                cfg, crossing, (local_ptrs, dmax_ind, dmax_val), det_max,
                ext_start + cfg.cp_len, state.last_det_ptr, state.any_det)
        valid = torch.arange(det_max, device=dev) < count[..., None]

    with profiling.span("ofdm.demod"):
        real_end = state.real_end + n_real
        chans, phasors, demod_ok = stream_rx.demod_detections(
            cfg, ext, l_ptrs, delays, valid, real_end - ext_start)

    with profiling.span("ofdm.decide"):
        new_state = ReacqState(hist=ext[..., -lag:].clone(),
                               base=state.base + chunk_len,
                               real_end=real_end, last_det_ptr=last_ptr,
                               any_det=any_det)
        out = ReacqChunkOut(ptrs=torch.where(valid, g_ptrs, -1),
                            delays=delays, peaks=peaks, valid=valid,
                            demod_ok=demod_ok, chans=chans, phasors=phasors,
                            hard_bits=stream_rx.hard_decide(cfg, phasors))
    return new_state, out, count


def _push_many(rx, chunks):
    """K chunk steps in one call for any receiver: outputs gain a leading K
    axis and equal those of K ``push`` calls exactly.  Full chunks only;
    partial and flush chunks go through ``push`` / ``finish``."""
    chunks = as_samples(chunks, rx.device)
    if chunks.shape[1:] != rx.chunk_shape:
        raise ValueError(f"push_many: chunks {tuple(chunks.shape)}, expected "
                         f"[K, {', '.join(map(str, rx.chunk_shape))}]")
    outs = [rx.push(c) for c in chunks]
    return type(outs[0])(*(torch.stack(f) for f in zip(*outs)))


def push_signal(rx, sig: np.ndarray, fields) -> tuple[int, dict]:
    """A whole single-stream signal through a receiver, as a file source
    feeds it: the full chunks in one ``push_many``, the zero-padded last
    one with its real sample count, then ``finish()``.  Returns (chunk
    steps, {field: the valid detections' values, on the host})."""
    chunk = rx.chunk_len
    n_full = len(sig) // chunk
    buf = np.zeros(-(-len(sig) // chunk) * chunk, np.complex64)
    buf[:len(sig)] = sig
    outs = []
    if n_full:
        many = rx.push_many(buf[:n_full * chunk].reshape(n_full, chunk))
        outs += [type(many)(*(f[j] for f in many)) for j in range(n_full)]
    for i in range(n_full * chunk, len(buf), chunk):
        outs.append(rx.push(buf[i:i + chunk], n_real=len(sig) - i))
    outs += rx.finish()
    valid = [o.valid.cpu().numpy() for o in outs]
    return len(outs), {name: np.concatenate(
        [getattr(o, name).cpu().numpy()[v] for o, v in zip(outs, valid)])
        for name in fields}


def _save_npz(path, state, complex_fields: dict) -> None:
    """A carry as npz: complex fields planar under <key>_re / <key>_im."""
    arrays = {}
    for field, value in state._asdict().items():
        a = value.cpu().numpy()
        if field in complex_fields:
            key = complex_fields[field]
            arrays[f"{key}_re"], arrays[f"{key}_im"] = a.real, a.imag
        else:
            arrays[field] = a
    np.savez_compressed(path, **arrays)


def _load_npz(path, like, complex_fields: dict):
    """The carry saved by :func:`_save_npz` (or by the JAX receiver), with
    the dtypes, shapes and device of the carry ``like``."""
    fields = {}
    with np.load(path) as z:
        for field, ref in like._asdict().items():
            if field in complex_fields:
                key = complex_fields[field]
                a = z[f"{key}_re"] + 1j * z[f"{key}_im"]
            else:
                a = z[field]
            t = torch.as_tensor(np.asarray(a)).to(device=ref.device,
                                                  dtype=ref.dtype)
            if t.shape != ref.shape:
                raise ValueError(f"checkpoint field {field}: shape "
                                 f"{tuple(t.shape)}, expected "
                                 f"{tuple(ref.shape)}")
            fields[field] = t
    return type(like)(**fields)


class EagerStreamingRx:
    """Host-side front end that the continuous receivers share: push(chunk)
    is one call of the reference block's work(), run as the step function
    on the carry, whose new carry it takes; finish() flushes the lag with
    zero chunks so that trailing detections resolve; npz checkpoints of the
    carry.  A subclass sets ``cfg``, ``chunk_len``, ``device``, ``det_max``,
    ``lag``, ``state`` and ``_step``."""

    batch = None        # BatchReacqStreamingRx: the number of streams

    @property
    def chunk_shape(self) -> tuple:
        return self.state.hist.shape[:-1] + (self.chunk_len,)

    def _samples(self, chunk) -> torch.Tensor:
        chunk = as_samples(chunk, self.device)
        if chunk.shape != self.chunk_shape:
            raise ValueError(f"push: chunk {tuple(chunk.shape)}, "
                             f"expected {tuple(self.chunk_shape)}")
        return chunk

    def push(self, chunk, n_real: int | None = None):
        """One chunk step; span ``ofdm.chunk_step``, the root of the
        step's stages."""
        with profiling.span("ofdm.chunk_step"):
            self.state, out = self._step(
                self.state, self._samples(chunk),
                self.chunk_len if n_real is None else n_real)
            return out

    def push_many(self, chunks):
        """K chunk steps in one call; see :func:`_push_many`."""
        return _push_many(self, chunks)

    def finish(self) -> list:
        """Flush the lag with zero chunks so that trailing trials resolve."""
        zeros = torch.zeros(self.chunk_shape, dtype=torch.complex64,
                            device=self.device)
        return [self.push(zeros, n_real=0)
                for _ in range(-(-self.lag // self.chunk_len))]

    # -- checkpoint and resume: the JAX receiver's npz keys ------------------
    def save_state(self, path) -> None:
        _save_npz(path, self.state, {"hist": "hist"})

    def load_state(self, path) -> None:
        self.state = _load_npz(path, self.state, {"hist": "hist"})


class _ReacqGraph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    chunk: torch.Tensor         # the chunk buffer the graph reads
    out: ReacqChunkOut          # the graph's outputs, rewritten each replay
    count: torch.Tensor         # the graph's detection count, the same
    launched: dict              # kernels.launch_state() keys: a replay's


class ReacqStreamingRx(EagerStreamingRx):
    """Host-side front end of the continuous multi-detection receiver
    (:class:`EagerStreamingRx`, on :func:`reacq_step`).

    Its carry is tensors made once: every step copies the new carry into
    them, ``state`` is a ``ReacqState`` of them, and assigning ``state`` or
    ``load_state`` copies into them.  On a CUDA device a full chunk (n_real
    None or chunk_len) runs as one replay of a CUDA graph of the step,
    captured at the first full chunk: a launch a step in place of some 160,
    the same kernels at the same precision, outputs cloned from the graph's
    (the next replay rewrites them), the kernels' launch counters raised by
    what the capture launched.  A partial chunk, the flush and every step
    on the CPU run the step eagerly on the same carry.  Counter
    ``ofdm.graph_steps``: 1 a replayed step, 0 an eager one."""

    def __init__(self, cfg: OFDMConfig, chunk_len: int, device=None):
        _stride_aligned(cfg, chunk_len)
        self.cfg = cfg
        self.chunk_len = chunk_len
        self.device = resolve_device(device)
        self.det_max = reacq_det_max(cfg, chunk_len)
        self.lag = reacq_lag(cfg)
        self._carry = reacq_init(cfg, self.device, self.batch)
        self._step = functools.partial(reacq_step, cfg,
                                       det_max=self.det_max)
        self._stages = functools.partial(_reacq_stages, cfg,
                                         det_max=self.det_max)
        self._graph = None

    @property
    def state(self) -> ReacqState:
        return self._carry

    @state.setter
    def state(self, value: ReacqState) -> None:
        for dst, src in zip(self._carry, value):
            dst.copy_(src)

    def push(self, chunk, n_real: int | None = None) -> ReacqChunkOut:
        """One chunk step; span ``ofdm.chunk_step``, the root of the
        step's stages (a replayed step runs none of their Python)."""
        with profiling.span("ofdm.chunk_step"):
            chunk = self._samples(chunk)
            if self.device.type == "cuda" and n_real in (None,
                                                         self.chunk_len):
                return self._replay(chunk)
            self.state, out = self._step(
                self.state, chunk,
                self.chunk_len if n_real is None else n_real)
            profiling.count("ofdm.graph_steps", 0)
            return out

    def _replay(self, chunk: torch.Tensor) -> ReacqChunkOut:
        if self._graph is None:
            self._graph = self._capture(chunk)
        g = self._graph
        g.chunk.copy_(chunk)
        g.graph.replay()
        kernels.add_launches(g.launched)
        if profiling.recording():
            profiling.count("ofdm.detections", g.count.clone())
            profiling.count("ofdm.slots", self.det_max * g.count.numel())
            profiling.count("ofdm.graph_steps", 1)
        return ReacqChunkOut(*(f.clone() for f in g.out))

    def _capture(self, chunk: torch.Tensor) -> _ReacqGraph:
        """The graph of one full chunk step on the carry and a chunk buffer
        (``_reacq_stages``, then the new carry copied into the carry).  Two
        warm-up steps on a side stream first make every table, FFT plan
        and workspace the step uses (the step is pure: they leave the carry
        as it is).  The launch counters end as they began; what the capture
        launched is what each replay adds."""
        buf = chunk.clone(memory_format=torch.contiguous_format)
        step = functools.partial(self._stages, n_real=self.chunk_len)
        before = kernels.launch_state()
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for _ in range(2):
                    step(self._carry, buf)
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            warm = kernels.launch_state()
            with torch.cuda.graph(graph):
                new_state, out, count = step(self._carry, buf)
                self.state = new_state
        after = kernels.launch_state()
        kernels.add_launches({k: before[k] - n for k, n in after.items()})
        return _ReacqGraph(graph, buf, out, count,
                           {k: n - warm[k] for k, n in after.items()
                            if n != warm[k]})


class BatchReacqStreamingRx(ReacqStreamingRx):
    """B independent continuous streams on one device (many carriers,
    antennas or users), each with its own history, refractory pointer and
    detection table, stepped together: one search launch and one demod
    launch a step, whatever B is.

    push(chunks)       [B, chunk_len]     -> ReacqChunkOut with a leading B
    push_many(chunks)  [K, B, chunk_len]  -> leading (K, B)

    ``n_real`` is one number for all streams: sources advance in lockstep
    and finish() pads every stream with the same zero chunks."""

    def __init__(self, cfg: OFDMConfig, chunk_len: int, batch: int,
                 device=None):
        self.batch = batch
        super().__init__(cfg, chunk_len, device)


class StreamingRx:
    """Host-side front end of the single-lock stream: one block whose work()
    is :func:`stream_step`, driven by push(chunk) calls."""

    _COMPLEX = {"hist": "hist", "chan_full": "chan"}

    def __init__(self, cfg: OFDMConfig, chunk_len: int,
                 num_patterns_total: int | None = None, device=None):
        _stride_aligned(cfg, chunk_len)
        if num_patterns_total is None:
            num_patterns_total = cfg.num_patterns
        self.cfg = cfg
        self.chunk_len = chunk_len
        self.chunk_shape = (chunk_len,)
        self.device = resolve_device(device)
        self.state = init_state(cfg, chunk_len, self.device)
        self._step = functools.partial(
            stream_step, cfg, num_patterns_total=num_patterns_total)

    def push(self, chunk) -> ChunkOut:
        chunk = as_samples(chunk, self.device)
        if chunk.shape != self.chunk_shape:
            raise ValueError(f"push: chunk {tuple(chunk.shape)}, expected "
                             f"[{self.chunk_len}]")
        self.state, out = self._step(self.state, chunk)
        return out

    def push_many(self, chunks) -> ChunkOut:
        """K chunk steps in one call; see :func:`_push_many`."""
        return _push_many(self, chunks)

    def finish(self) -> ChunkOut:
        """Push zeros so that trailing blocks inside the history resolve."""
        return self.push(torch.zeros(self.chunk_len, dtype=torch.complex64,
                                     device=self.device))

    # -- checkpoint and resume: the JAX receiver's ten npz keys --------------
    def save_state(self, path) -> None:
        _save_npz(path, self.state, self._COMPLEX)

    def load_state(self, path) -> None:
        self.state = _load_npz(path, self.state, self._COMPLEX)


# ---------------------------------------------------------------------------
# Streaming legacy CFO/DSSS receiver
# ---------------------------------------------------------------------------
#
# The legacy blocks run forever as streaming blocks: every call slides the
# CFO x delay search over the new samples, the detection table grows across
# calls, and each detection demodulates the one data symbol that follows it,
# re-mixed by its winning CFO candidate and then despread.
# models/legacy_rx.py is the whole-buffer form; here the same math runs
# chunk by chunk with the refractory rule carried across chunk edges, so the
# chunked outputs equal the whole-buffer run's.


def legacy_lag(cfg: OFDMConfig) -> int:
    """History length of the legacy stream: a trial at local pointer cp
    reads its synch pattern and its one data symbol, rounded up to a stride
    multiple so that chunk trial grids stay aligned."""
    need = cfg.cp_len + cfg.m_synch * cfg.rx_b_len + cfg.nfft
    s = max(1, cfg.stride)
    return -(-need // s) * s


class LegacyStreamState(NamedTuple):
    hist: torch.Tensor          # [lag] trailing samples
    base: torch.Tensor          # global index of the next chunk's start
    real_end: torch.Tensor      # global count of real (non-flush) samples
    last_det_ptr: torch.Tensor
    any_det: torch.Tensor


class LegacyChunkOut(NamedTuple):
    ptrs: torch.Tensor       # [det_max] global detection pointers, or -1
    delays: torch.Tensor     # [det_max] winning delay hypotheses
    peaks: torch.Tensor      # [det_max] correlation peaks
    fo_idx: torch.Tensor     # [det_max] winning CFO candidate index
    valid: torch.Tensor      # [det_max] bool
    demod_ok: torch.Tensor   # [det_max] bool: data window in real samples
    chans: torch.Tensor      # [det_max, nfft] per-detection channel
    phasors: torch.Tensor    # [det_max, num_data_bins] equalised data
    despread: torch.Tensor   # [det_max, num_data_bins/dsss]


def legacy_init(cfg: OFDMConfig, device=None) -> LegacyStreamState:
    device = resolve_device(device)
    i32 = functools.partial(_scalar, 0, torch.int32, device)
    return LegacyStreamState(
        hist=torch.zeros(legacy_lag(cfg), dtype=torch.complex64,
                         device=device),
        base=i32(), real_end=i32(), last_det_ptr=i32(),
        any_det=_scalar(False, torch.bool, device))


def legacy_stream_step(cfg: OFDMConfig, state: LegacyStreamState,
                       chunk: torch.Tensor, n_real, det_max: int,
                       bank: torch.Tensor, dsss: int = 1
                       ) -> tuple[LegacyStreamState, LegacyChunkOut]:
    """One chunk of the continuous CFO-search receiver
    (``stream.py:legacy_stream_step``).  The trial grid is ``reacq_step``'s
    (trials lag ``legacy_lag`` behind the input, so every trial's whole
    reach is readable in ext = [hist, chunk]); the search is the
    candidate-by-candidate scan of ``ops/cfo.py`` in plain torch, and the
    per-detection demod one K2 call over the detection table.  Static
    shapes, the carry on the device,
    nothing waits for the host."""
    chunk_len = chunk.shape[-1]
    stride = _stride_aligned(cfg, chunk_len)
    lag = legacy_lag(cfg)
    dev = chunk.device
    ext = torch.cat([state.hist, chunk], -1)
    ext_start = state.base - lag                 # global coordinate of ext[0]

    t_per = chunk_len // stride
    dmax_val, delay_win, fo_win = cfo_ops.cfo_search_scan(cfg, ext, t_per,
                                                          bank)
    local_ptrs = cfg.cp_len + stride * torch.arange(t_per, device=dev)
    global_ptrs = ext_start[..., None] + local_ptrs
    crossing = (dmax_val > sync.gate_level(cfg)) & (global_ptrs >= cfg.cp_len)

    g_ptrs, (l_ptrs, delays, fo_sel, peaks), count, (last_ptr, any_det) = \
        sync.refractory_table(
            cfg, crossing, (local_ptrs, delay_win, fo_win, dmax_val),
            det_max, ext_start + cfg.cp_len, state.last_det_ptr,
            state.any_det)
    valid = torch.arange(det_max, device=dev) < count[..., None]

    # channel estimate of each detection from its own re-mixed spectrum
    det_spec = cfo_ops.spectra_at_detections(
        cfg, ext, torch.where(valid, l_ptrs, 0), fo_sel, bank)
    _, chans, _ = sync.estimate_channel(cfg, det_spec,
                                        delays.to(torch.int64))
    chans = chans * valid[..., None]

    # one data symbol per detection, gated on its window lying in real
    # samples
    real_end = state.real_end + n_real
    data_off = cfg.m_synch * cfg.rx_b_len
    demod_ok = valid & (g_ptrs + data_off + cfg.nfft <= real_end[..., None])
    phasors = legacy_rx.demod_after_detections(
        cfg, ext, torch.where(demod_ok, l_ptrs + data_off, 0), demod_ok,
        delays, fo_sel, chans, bank)

    new_state = LegacyStreamState(
        hist=ext[..., -lag:].clone(), base=state.base + chunk_len,
        real_end=real_end, last_det_ptr=last_ptr, any_det=any_det)
    out = LegacyChunkOut(
        ptrs=torch.where(valid, g_ptrs, -1), delays=delays, peaks=peaks,
        fo_idx=fo_sel, valid=valid, demod_ok=demod_ok, chans=chans,
        phasors=phasors, despread=cfo_ops.dsss_despread(phasors, dsss))
    return new_state, out


class LegacyStreamingRx(EagerStreamingRx):
    """Host-side front end of the continuous CFO/DSSS receiver: push(chunk)
    is one call of the legacy block's work(), finish() flushes the lag so
    that trailing detections and their data symbols resolve.  ``push``,
    ``push_many``, ``finish`` and the npz checkpoints (the JAX receiver's
    six keys) are :class:`EagerStreamingRx`'s."""

    def __init__(self, cfg: OFDMConfig, chunk_len: int, fo_range=(0.0,),
                 dsss: int = 1, device=None):
        _stride_aligned(cfg, chunk_len)
        self.cfg = cfg
        self.chunk_len = chunk_len
        self.device = resolve_device(device)
        self.det_max = reacq_det_max(cfg, chunk_len)
        self.lag = legacy_lag(cfg)
        self.state = legacy_init(cfg, self.device)
        self._step = functools.partial(
            legacy_stream_step, cfg, det_max=self.det_max,
            bank=cfo_ops.bank_on(cfg, fo_range, self.device), dsss=dsss)


# ---------------------------------------------------------------------------
# Streaming tracker (the GR tracker block's work() semantics)
# ---------------------------------------------------------------------------
#
# The tracker block carries its pointer state machine across work() calls:
# search by stride, five nominal advances, then least-squares drift
# prediction.  Here the batch tracker's step loop (kernels/tracker.py:
# track_scan: one kernel launch a chunk step on the card, one warp or block
# a stream) runs over ext = [hist, chunk] of every stream, with the carry
# in the stream state; fire-or-stall steps make the chunked run accept
# exactly the whole buffer's detections.  The fit is exact at any global
# sample index below 2^31 (models/tracker.py), the int32 horizon of every
# streaming receiver here: 140 s of a 15.36 Msps stream.


def tracker_lag(cfg: OFDMConfig) -> int:
    """History: the pattern reach plus pointer-regression slack (the lstsq
    prediction can step back by ~cp/4; give it 2*cp)."""
    return cfg.pattern_len * cfg.rx_b_len + cfg.nfft + 2 * cfg.cp_len


class TrackStreamState(NamedTuple):
    hist: torch.Tensor          # [B, lag] trailing samples
    base: torch.Tensor          # [B] global index of the next chunk's start
    real_end: torch.Tensor      # [B] global count of real (non-flush) samples
    carry: tuple                # models/tracker.py:TrackerCarry, [B] rows


class TrackChunkOut(NamedTuple):
    ptrs: torch.Tensor          # [..., det_max] global detection pointers, or -1
    delays: torch.Tensor        # [..., det_max]
    peaks: torch.Tensor         # [..., det_max]
    valid: torch.Tensor         # [..., det_max] bool
    chans: torch.Tensor         # [..., det_max, nfft]
    phasors: torch.Tensor       # [..., det_max, nd, num_data_bins]
    hard_bits: torch.Tensor     # [..., det_max, nd, num_data_bins*bits_per_bin]


def track_stream_init(cfg: OFDMConfig, batch: int = 1,
                      device=None) -> TrackStreamState:
    """The empty carry of ``batch`` streams, each field with a leading
    stream axis."""
    device = resolve_device(device)
    i32 = functools.partial(_scalar, 0, torch.int32, device, batch)
    return TrackStreamState(
        hist=torch.zeros(batch, tracker_lag(cfg), dtype=torch.complex64,
                         device=device),
        base=i32(), real_end=i32(),
        carry=tracker.tracker_init_carry(batch, device))


def track_stream_step(cfg: OFDMConfig, state: TrackStreamState,
                      chunk: torch.Tensor, n_real, slots: int, det_max: int
                      ) -> tuple[TrackStreamState, TrackChunkOut]:
    """One chunk of B streaming trackers (``stream.py:track_stream_step``,
    with a stream axis): chunk [B, chunk_len], ``n_real`` the chunk's real
    samples (one number for all).  ``slots`` tracker steps over each
    stream's ext = [hist, chunk] (one ``track_scan``: one kernel launch on
    the card, which also returns the channel tables compacted), the
    accepted ones compacted into a [B, det_max] table, each demodulated
    (``models/tracker.py:track_phasors``: one K2 launch) and decided
    (``stream_rx.hard_decide``).  A step fires only where its synch windows
    lie inside the real samples and its pattern's data span inside ext, so
    a pointer that does not fit yet is retried next chunk.  Static shapes, the carry on the device,
    nothing waits for the host.

    Spans ``ofdm.track``, ``ofdm.select``, ``ofdm.demod``,
    ``ofdm.decide``; counters ``ofdm.detections`` (the table's count),
    ``ofdm.slots`` (streams x det_max) and ``ofdm.fired`` (the steps the
    scan computed a stream: the loop count's growth, and the one step that
    did not fire, whose window it correlates before it leaves its loop;
    computed only while a profiler records)."""
    chunk_len = chunk.shape[-1]
    lag = tracker_lag(cfg)
    m0, nd = cfg.m_synch, cfg.synch_dat[1]
    with profiling.span("ofdm.track"):
        ext = torch.cat([state.hist, chunk], -1)
        ext_start = state.base - lag             # global coordinate of ext[0]
        real_end = state.real_end + n_real
        fire_limit = torch.minimum(
            real_end, state.base + chunk_len - (nd - m0 + 1) * cfg.rx_b_len
            + 1)
        carry, (acc, ptrs_all, dels_all, peaks_all, chans) = \
            tracker_kernel.track_scan(cfg, ext, ext_start, fire_limit,
                                      state.carry, slots, det_max)

    with profiling.span("ofdm.select"):
        (g_ptrs, delays, peaks), count = sync.emit_slots(
            acc, (ptrs_all, dels_all, peaks_all), det_max)
        valid = torch.arange(det_max, device=chunk.device) < count[:, None]
    profiling.count("ofdm.detections", count)
    profiling.count("ofdm.slots", det_max * count.numel())
    if profiling.recording():
        profiling.count("ofdm.fired", (carry.loop_count -
                                       state.carry.loop_count + 1
                                       ).clamp_max(slots))

    with profiling.span("ofdm.demod"):
        ptrs_local = torch.where(valid, g_ptrs - ext_start[:, None], 0)
        phasors = tracker.track_phasors(cfg, ext, ptrs_local, delays, valid,
                                        real_end - ext_start, chans)

    with profiling.span("ofdm.decide"):
        new_state = TrackStreamState(
            hist=ext[..., -lag:].clone(), base=state.base + chunk_len,
            real_end=real_end, carry=carry)
        out = TrackChunkOut(
            ptrs=torch.where(valid, g_ptrs, -1), delays=delays, peaks=peaks,
            valid=valid, chans=chans, phasors=phasors,
            hard_bits=stream_rx.hard_decide(cfg, phasors))
    return new_state, out


class BatchTrackerStreamingRx:
    """Host-side front end of B streaming trackers on one device (many
    carriers), each with its own history and pointer state machine,
    stepped together: one tracker launch and one demod launch a chunk step,
    whatever B is.  push(chunks) is one call of the tracker block's work()
    on every stream, finish() flushes the history with zero chunks.  No
    checkpoints: the JAX receiver has none.

    push(chunks)       [B, chunk_len]     -> TrackChunkOut with a leading B
    push_many(chunks)  [K, B, chunk_len]  -> leading (K, B)

    ``n_real`` is one number for all streams: sources advance in lockstep
    and finish() pads every stream with the same zero chunks."""

    def __init__(self, cfg: OFDMConfig, chunk_len: int, batch: int,
                 device=None):
        self.cfg = cfg
        self.chunk_len = chunk_len
        self.batch = batch
        self.device = resolve_device(device)
        self.slots = chunk_len // tracker.tracker_stride(cfg) + 4
        self.det_max = chunk_len // (2 * cfg.cp_len + cfg.nfft) + 2
        self.state = track_stream_init(cfg, batch, self.device)
        self._step = functools.partial(
            track_stream_step, cfg, slots=self.slots, det_max=self.det_max)

    @property
    def chunk_shape(self) -> tuple:
        return (self.batch, self.chunk_len)

    def push(self, chunk, n_real: int | None = None) -> TrackChunkOut:
        """One chunk step of every stream; span ``ofdm.chunk_step``, the
        root of the step's stages."""
        with profiling.span("ofdm.chunk_step"):
            chunk = as_samples(chunk, self.device)
            if chunk.shape != self.chunk_shape:
                raise ValueError(f"push: chunk {tuple(chunk.shape)}, "
                                 f"expected {list(self.chunk_shape)}")
            self.state, out = self._step(
                self.state, chunk.reshape(self.batch, self.chunk_len),
                self.chunk_len if n_real is None else n_real)
            return out

    def push_many(self, chunks) -> TrackChunkOut:
        """K chunk steps in one call; see :func:`_push_many`."""
        return _push_many(self, chunks)

    def finish(self) -> list[TrackChunkOut]:
        """Zero chunks until the history and one chunk more have passed, so
        that every pointer inside the real samples resolves."""
        zeros = torch.zeros(self.chunk_shape, dtype=torch.complex64,
                            device=self.device)
        n = -(-(tracker_lag(self.cfg) + self.chunk_len) // self.chunk_len)
        return [self.push(zeros, n_real=0) for _ in range(n)]


class TrackerStreamingRx(BatchTrackerStreamingRx):
    """The streaming tracker of one stream: :class:`BatchTrackerStreamingRx`
    at B = 1, its chunks [chunk_len] and its outputs without the stream
    axis."""

    def __init__(self, cfg: OFDMConfig, chunk_len: int, device=None):
        super().__init__(cfg, chunk_len, 1, device)

    @property
    def chunk_shape(self) -> tuple:
        return (self.chunk_len,)

    def push(self, chunk, n_real: int | None = None) -> TrackChunkOut:
        out = super().push(chunk, n_real)
        return TrackChunkOut(*(f[0] for f in out))
