"""The tracking entry: ``runtime/stream.py:BatchTrackerStreamingRx.push``,
one step = one chunk of each of ``streams`` carriers that arrive together,
each carrier tracked by the reference's pointer state machine (search,
nominal advances, then the least-squares drift prediction) from chunk to
chunk.

Each carrier is a ring of ``ring_frames`` frames made in set-up from the
seed, as ``entries/reacq.py`` makes it: the reference's TX of seeded bits,
the config's channel as a circular convolution over the ring, AWGN at
``snr_db``, so that the stream runs on across the ring's wrap on the
pattern grid.  Step i pushes samples [i C, (i + 1) C) of every stream.
The step returns the receiver's state from before the push with its
output: the receiver builds a new state each step and changes none, so
keeping it costs nothing.

An answer is one stream's chunk step: its detections' pointers, delays,
channels, phasors and hard bits, with the state it was handed.  Its check:

(a) the plain reference (``reference/tracker.py``, float64) runs the same
    step from the handed state's loop variables and history (it fits the
    history itself and never reads the state's fit) over the ring's
    samples: the count, pointers, delays and which data symbols lie in the
    real samples exactly, the hard bits by ``judge.wrong_bits``, the
    channel and phasor gaps under their limits;
(b) the pattern grid: every detection's symbol boundary ptr + delay lies
    on the ring's grid, at the offset the reference finds on the ring's
    first patterns; the detections are the patterns that follow the
    handed state's newest one, in order, once each, and every pattern
    whose synch window completes inside the step is among them.  A stream
    whose carry lost the cadence fails (b) even where (a) follows it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import judge
from ..reference import golden, vector
from ..reference import tracker as ref
from ..reference.numerology import RefConfig

FIELDS = ("ptrs", "delays", "valid", "chans", "phasors", "hard_bits")
CARRY = ("loop_count", "corr_obs", "ptr_frame", "ptr_adj", "sym_count",
         "last_ptr")
GENIE_FRAMES = 2        # the ring's first frames the grid's offset is read on


class Entry:
    loop = "open"

    def __init__(self, config: dict, traffic: dict, device):
        from lte_gnu_radio_code_tpu_torch.runtime import stream
        from lte_gnu_radio_code_tpu_torch.utils.params import OFDMConfig

        names = {f.name for f in dataclasses.fields(OFDMConfig)}
        kw = {k: v for k, v in config.items() if k in names}
        kw["synch_dat"] = tuple(kw["synch_dat"])
        kw["snr_db"] = float(traffic["snr_db"])
        self.cfg = OFDMConfig(**kw).validate()
        self.ref_cfg = RefConfig.from_keywords(kw)
        self._stream = stream
        self.device = device
        self.batch = int(traffic["streams"])
        self.chunk = int(traffic["chunk"])
        self.rate_hz = float(traffic["rate_hz"])
        self.ring_frames = int(traffic["ring_frames"])
        # the stream's first global sample: 0 in the cell; a test starts
        # the stream past 2^24, where a float32 pointer fit breaks
        self.origin = 0
        self.lag = stream.tracker_lag(self.cfg)
        self.samples_per_step = self.batch * self.chunk
        self.answers_per_step = self.batch
        self.strata = 1
        self.rx = None
        self._handed: dict = {}
        self._grid: dict = {}

    def make_inputs(self, seed: int) -> None:
        """The rings (host, in bulk) and a receiver with an empty carry
        whose stream starts at global sample ``origin``."""
        c = self.ref_cfg
        rng = np.random.default_rng(seed)
        bits = rng.integers(0, 2, (self.batch * self.ring_frames,
                                   c.num_bits))
        tx = vector.tx_frames(c, bits).reshape(self.batch, -1)
        h = golden.channel_taps(c.channel if c.channel != "AWGN"
                                else "Ideal")
        y = sum(tap * np.roll(tx, k, axis=-1) for k, tap in enumerate(h))
        nv = vector.noise_power(c, np.var(tx, axis=-1))[:, None]
        noise = rng.standard_normal((2, *tx.shape))
        ring = (y + np.sqrt(nv / 2.0) * (noise[0] + 1j * noise[1])).astype(
            np.complex64)
        self.ring = ring
        reps = -(-(ring.shape[1] + self.chunk) // ring.shape[1])
        ext = np.tile(ring, (1, reps))[:, :ring.shape[1] + self.chunk]
        self.ring_dev = torch.from_numpy(ext).to(self.device)
        self.rx = self._stream.BatchTrackerStreamingRx(
            self.cfg, self.chunk, self.batch, device=self.device)
        if self.origin:
            st = self.rx.state
            stride = ref.stride(self.ref_cfg)
            self.rx.state = st._replace(
                base=torch.full_like(st.base, self.origin),
                real_end=torch.full_like(st.real_end, self.origin),
                carry=st.carry._replace(loop_count=torch.full_like(
                    st.carry.loop_count, self.origin // stride)))
        self.next_i = 0
        self._handed, self._grid = {}, {}

    def warm_steps(self) -> int:
        """Two steps: the first runs with the empty history, the second as
        every later one."""
        return 2

    def step(self, i: int):
        if i != self.next_i:
            raise ValueError(f"step {i}: the stream is at step {self.next_i}")
        self.next_i += 1
        off = (i * self.chunk) % self.ring.shape[1]
        handed = self.rx.state
        return handed, self.rx.push(self.ring_dev[:, off:off + self.chunk])

    def k4_shape(self) -> dict:
        """The tracker scan's shape, for ``metrics/tracker_roofline.py``."""
        c = self.cfg
        return dict(batch=self.batch, n=self.lag + self.chunk, nfft=c.nfft,
                    cp=c.cp_len, m_synch=c.m_synch,
                    num_synch_bins=c.num_synch_bins, rx_b_len=c.rx_b_len,
                    steps=self.rx.slots, max_det=self.rx.det_max)

    # -- the check -----------------------------------------------------------
    def answers(self, i: int, out, streams: np.ndarray):
        """The streams ``streams`` of step i's output with the state each
        was handed, on the host: [(key, program answer)]."""
        handed, o = out
        res = []
        for b in streams:
            b = int(b)
            host = {f: getattr(o, f)[b].cpu().numpy() for f in FIELDS}
            v = host["valid"]
            got = {f: host[f][v] for f in FIELDS}
            got["ok"] = np.abs(got["phasors"]).max(-1, initial=0.0) > 0
            self._handed[(i, b)] = dict(
                base=int(handed.base[b]), real_end=int(handed.real_end[b]),
                **{f: int(getattr(handed.carry, f)[b]) for f in CARRY},
                hx=handed.carry.hx[b].tolist(),
                hy=handed.carry.hy[b].tolist())
            res.append(((i, b), got))
        return res

    def _samples(self, b: int, start: int, end: int) -> torch.Tensor:
        """Stream b's global samples [start, end), float64, from the ring
        (zero before the stream's first sample)."""
        g = np.arange(start, end) - self.origin
        x = self.ring[b, g % self.ring.shape[1]].astype(np.complex128)
        return torch.from_numpy(np.where(g >= 0, x, 0))

    def _reference(self, key, ar=ref.FLOAT64, follow=None, tie=0.0):
        """The reference's chunk step of stream b from the state handed to
        step i: its detection table (the first det_max), phasors, ok and
        hard bits, the decisions it followed."""
        i, b = key
        h = self._handed[key]
        c = self.ref_cfg
        m0, nd = c.m_synch, c.synch_dat[1]
        x_start = h["base"] - self.lag
        end = h["base"] + self.chunk
        real_end = h["real_end"] + self.chunk
        fire_limit = min(real_end, end - (nd - m0 + 1) * c.rx_b_len + 1)
        st = ref.State(**{f: h[f] for f in CARRY}, hx=list(h["hx"]),
                       hy=list(h["hy"]))
        tab = ref.Tables(c, ar)
        x = self._samples(b, x_start, end)
        _, dets, followed, _ = ref.step(tab, x, x_start, fire_limit, st,
                                        self.rx.slots, follow, tie)
        dets = dets[:self.rx.det_max]
        ph, ok, hard = ref.demod(tab, x, x_start, real_end, dets)
        return dets, ph, ok, hard, followed

    def control(self, key) -> dict:
        """The reference one precision below the program's, in its place."""
        dets, ph, ok, hard, _ = self._reference(key, ref.TF32)
        k = len(dets)
        return dict(ptrs=np.array([d.ptr for d in dets], np.int64),
                    delays=np.array([d.delay for d in dets], np.int64),
                    valid=np.ones(k, bool),
                    chans=np.stack([d.chan.numpy() for d in dets])
                    if k else np.zeros((0, self.cfg.nfft), np.complex64),
                    phasors=ph.numpy(), hard_bits=hard.numpy(),
                    ok=ok.numpy())

    def grid(self, b: int) -> tuple[set, int]:
        """The offsets of the pattern grid (symbol boundaries ptr + delay,
        modulo the pattern's samples) the float64 reference finds on stream
        b's first ``GENIE_FRAMES`` ring frames from an empty state, and the
        delay of its last detection there (its pointer's place before the
        boundary once it tracks)."""
        if b not in self._grid:
            c = self.ref_cfg
            n = min(GENIE_FRAMES * c.frame_len, self.ring.shape[1])
            _, dets, _, _, _ = ref.track(c, self.ring[b, :n])
            period = c.pattern_len * c.rx_b_len
            self._grid[b] = ({(d.ptr + d.delay) % period for d in dets},
                             dets[-1].delay)
        return self._grid[b]

    def genie(self, key, got: dict) -> int:
        """(b): the detections of one stream step that break the pattern
        grid (module docstring), 0 where none does."""
        i, b = key
        h = self._handed[key]
        c = self.ref_cfg
        period = c.pattern_len * c.rx_b_len
        offsets, delay = self.grid(b)
        o = self.origin % period
        bounds = np.asarray(got["ptrs"], np.int64) + np.asarray(
            got["delays"], np.int64) - o
        on = [int(v) % period in offsets for v in bounds]
        bad = len(on) - sum(on)
        phase = min(offsets)
        ks = (bounds - phase) // period
        k_prev = None
        if h["sym_count"] > 0:
            newest = h["hy"][(h["sym_count"] - 1) % ref.HISTORY] - o
            if newest % period not in offsets:
                return bad + 1                  # the carry is off the grid
            k_prev = (newest - phase) // period
        if len(ks) and (np.diff(ks) != 1).any():
            bad += int((np.diff(ks) != 1).sum())
        if k_prev is not None and len(ks) and ks[0] != k_prev + 1:
            bad += 1
        if k_prev is not None:
            m0, nd = c.m_synch, c.synch_dat[1]
            span = (m0 - 1) * c.rx_b_len + c.nfft
            end = h["base"] + self.chunk
            limit = min(h["real_end"] + self.chunk,
                        end - (nd - m0 + 1) * c.rx_b_len + 1) - o
            slack = c.cp_len // 2
            k = np.arange(k_prev + 1, k_prev + 2 + self.chunk // period)
            start = phase + k * period - delay
            need = int((start + span + slack < limit).sum())
            may = int((start + span - slack < limit).sum())
            n = min(len(ks), self.rx.det_max)
            if not need <= n <= may and n < self.rx.det_max:
                bad += 1 + abs(n - need)
        return bad

    def judge(self, key, got: dict, limits: dict) -> dict:
        """The numbers one stream's chunk step gives: detections that
        differ from the reference's (count, pointer, delay, the data
        symbols in the real samples) or break the pattern grid, hard bits
        wrong away from a boundary, the widest channel and phasor gaps."""
        c = self.ref_cfg
        tie = limits["tie_share_of_gate"] * vector.gate(c)
        ptrs = np.asarray(got["ptrs"], np.int64)
        follow = list(zip(ptrs.tolist(), np.asarray(got["delays"]).tolist()))
        dets, ph, ok, hard, followed = self._reference(key, follow=follow,
                                                       tie=tie)
        out = dict(wrong_decisions=self.genie(key, got), wrong_bits=0,
                   phasor_gap=0.0, chan_gap=0.0, followed=followed)
        k = len(dets)
        if len(ptrs) != k:
            out["wrong_decisions"] += abs(len(ptrs) - k) + 1
            return out
        ok = ok.numpy()
        wrong = int((ptrs != [d.ptr for d in dets]).sum() +
                    (np.asarray(got["delays"]) != [d.delay for d in dets]
                     ).sum() + (np.asarray(got["ok"]) != ok).sum())
        if wrong or not k:
            out["wrong_decisions"] += wrong
            return out
        ref_chans = torch.stack([d.chan for d in dets]).numpy()
        out["chan_gap"] = float(np.abs(got["chans"] - ref_chans).max())
        rph = ph.numpy()
        gph = np.asarray(got["phasors"])
        out["phasor_gap"] = float(np.abs(gph[ok] - rph[ok]).max(initial=0.0))
        out["wrong_bits"] = judge.wrong_bits(
            np.asarray(got["hard_bits"])[ok], hard.numpy()[ok], rph[ok],
            limits["phasor_gap"])
        return out
