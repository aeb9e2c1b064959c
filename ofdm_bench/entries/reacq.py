"""The live entry: ``runtime/stream.py:BatchReacqStreamingRx.push``, one
step = one chunk of each of ``streams`` carriers that arrive together.

Each carrier is a ring of ``ring_frames`` frames made in set-up from the
seed: the reference's TX (``reference/vector.py``) of seeded bits, the
config's channel as a circular convolution over the ring and AWGN at
``snr_db``, so that the stream runs on across the ring's wrap on the frame
grid.  Step i pushes samples [i C, (i + 1) C) of every stream.  An answer
is one stream's chunk step: its detections' ptrs, delays, valid, demod_ok,
chans, phasors and hard bits, held to the reference's ``rx_stream`` over
the same samples from two pattern blocks before the step's history on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import judge
from ..reference import golden, vector
from ..reference.numerology import RefConfig

FIELDS = ("ptrs", "delays", "valid", "demod_ok", "chans", "phasors",
          "hard_bits")


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
        self.lag = stream.reacq_lag(self.cfg)
        self.samples_per_step = self.batch * self.chunk
        self.answers_per_step = self.batch
        self.strata = 1
        self.rx = None

    def make_inputs(self, seed: int) -> None:
        """The rings (host, in bulk) and a receiver with an empty carry."""
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
        self.rx = self._stream.BatchReacqStreamingRx(
            self.cfg, self.chunk, self.batch, device=self.device)
        self.next_i = 0

    def warm_steps(self) -> int:
        """Two steps: the first runs with the empty history, the second as
        every later one."""
        return 2

    def step(self, i: int):
        if i != self.next_i:
            raise ValueError(f"step {i}: the stream is at step {self.next_i}")
        self.next_i += 1
        off = (i * self.chunk) % self.ring.shape[1]
        return self.rx.push(self.ring_dev[:, off:off + self.chunk])

    def k4_shape(self) -> dict:
        c = self.cfg
        return dict(batch=self.batch, n=self.lag + self.chunk,
                    n_trials=self.chunk // c.stride, nfft=c.nfft,
                    cp=c.cp_len, m_synch=c.m_synch)

    # -- the check -----------------------------------------------------------
    def answers(self, i: int, out, streams: np.ndarray):
        """The streams ``streams`` of step i's output, on the host: [(key,
        program answer with its valid detections)]."""
        res = []
        for b in streams:
            host = {f: getattr(out, f)[int(b)].cpu().numpy() for f in FIELDS}
            v = host["valid"]
            res.append(((i, int(b)), {f: host[f][v] for f in FIELDS}))
        return res

    def _segment(self, key):
        """The stream's samples the reference reads for step i, from two
        pattern blocks before the step's history, and the range of
        pointers the step reports, relative to the segment."""
        i, b = key
        c = self.ref_cfg
        s = c.stride              # on the stream's trial grid
        lead = -(-2 * c.pattern_len * c.rx_b_len // s) * s
        g0 = max(0, i * self.chunk - self.lag - lead)
        end = (i + 1) * self.chunk
        idx = np.arange(g0, end) % self.ring.shape[1]
        x = self.ring[b, idx].astype(np.complex128)
        lo = i * self.chunk - self.lag + c.cp_len - g0
        return x, g0, lo, lo + self.chunk

    def control(self, key) -> dict:
        """The reference one precision below the program's, in its place."""
        x, g0, lo, hi = self._segment(key)
        r = vector.stream_detections(self.ref_cfg, x, lo, hi, vector.TF32)
        return dict(ptrs=r["ptrs"] + g0, delays=r["delays"],
                    valid=np.ones(len(r["ptrs"]), bool),
                    demod_ok=r["demod_ok"], chans=r["chans"],
                    phasors=r["phasors"], hard_bits=r["hard_bits"])

    def judge(self, key, got: dict, limits: dict) -> dict:
        """The numbers one stream's chunk step gives: detections that
        differ from the reference's (count, pointer, delay, demod_ok), hard
        bits wrong away from a boundary, the widest channel and phasor
        gaps."""
        x, g0, lo, hi = self._segment(key)
        c = self.ref_cfg
        tie = limits["tie_share_of_gate"] * vector.gate(c)
        ptrs = np.asarray(got["ptrs"], np.int64) - g0
        follow = list(zip(ptrs.tolist(), np.asarray(got["delays"]).tolist()))
        ref = vector.stream_detections(c, x, lo, hi, follow=follow, tie=tie)
        out = dict(wrong_decisions=0, wrong_bits=0, phasor_gap=0.0,
                   chan_gap=0.0, followed=ref["followed"])
        k = len(ref["ptrs"])
        if len(ptrs) != k:
            out["wrong_decisions"] = abs(len(ptrs) - k) + 1
            return out
        wrong = int((ptrs != ref["ptrs"]).sum() +
                    (np.asarray(got["delays"]) != ref["delays"]).sum() +
                    (np.asarray(got["demod_ok"]) != ref["demod_ok"]).sum())
        if wrong or not k:
            out["wrong_decisions"] = wrong
            return out
        ok = ref["demod_ok"]
        out["chan_gap"] = float(np.abs(got["chans"] - ref["chans"]).max())
        ph = np.asarray(got["phasors"])
        out["phasor_gap"] = float(np.abs(ph[ok] - ref["phasors"][ok]
                                         ).max(initial=0.0))
        out["wrong_bits"] = judge.wrong_bits(
            np.asarray(got["hard_bits"])[ok], ref["hard_bits"][ok],
            ref["phasors"][ok], limits["phasor_gap"])
        return out
