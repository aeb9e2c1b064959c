"""The 2x2 link entry: ``models/mimo.py:make_mimo_chain`` (spatial
multiplexing, two layers) on its kernel path, one step = one batch of
frames at one SNR point (a BER curve of both layers).

The inputs are a pool of ``pool_steps`` batches of bits [frames, 2,
num_bits] and unit noise [frames, 2, frame_len + nfft - 1] (real and
imaginary parts N(0, 1), as ``ops/channel.py:awgn`` takes it), made on the
device from the seed; step i takes pool entry i mod ``pool_steps`` at SNR
point i mod len(``snr_db``).  A step's samples are both RX antennas'.  An
answer is one frame: found, lock_ptr, delay_idx, both layers' hard_bits and
ber, phasors and the 2x2 channel estimate, held to the plain reference's
TX, channel, AWGN (the same noise) and RX of the same bits
(``reference/mimo.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import judge
from ..reference import mimo as ref
from ..reference.numerology import RefConfig

FIELDS = ("found", "lock_ptr", "delay_idx", "hard_bits", "ber", "phasors",
          "chan_freq")


class Entry:
    loop = "closed"

    def __init__(self, config: dict, traffic: dict, device):
        from lte_gnu_radio_code_tpu_torch.models import mimo
        from lte_gnu_radio_code_tpu_torch.utils.params import OFDMConfig

        names = {f.name for f in dataclasses.fields(OFDMConfig)}
        kw = {k: v for k, v in config.items() if k in names}
        kw["synch_dat"] = tuple(kw["synch_dat"])
        base = OFDMConfig(**kw).validate()
        self.device = device
        self.batch = int(traffic["frames"])
        self.pool_steps = int(traffic["pool_steps"])
        self.snrs = [float(s) for s in traffic["snr_db"]]
        self.chan = config["channel"]
        self.steps = [mimo.make_mimo_chain(
            dataclasses.replace(base, snr_db=s).validate(), self.chan,
            device) for s in self.snrs]
        self.ref_cfgs = [RefConfig.from_keywords(dict(kw, snr_db=s))
                         for s in self.snrs]
        self.n = base.frame_len + base.nfft - 1
        self.n_trials, self.num_patterns = mimo.plan(base, self.n)
        self.m_synch = mimo.search_config(base).m_synch
        self.base = base
        self.samples_per_step = self.batch * 2 * self.n
        self.answers_per_step = self.batch
        self.strata = len(self.snrs)      # the check keeps every SNR point
        self.bits = self.noise = None

    def make_inputs(self, seed: int) -> None:
        """The pool, in two calls of one generator on the device."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        shape = (self.pool_steps, self.batch, 2)
        self.bits = torch.randint(0, 2, (*shape, self.base.num_bits),
                                  generator=g, device=self.device,
                                  dtype=torch.int32)
        ri = torch.randn((2, *shape, self.n), generator=g,
                         device=self.device)
        self.noise = torch.complex(ri[0], ri[1])

    def warm_steps(self) -> int:
        """Every SNR point's configuration once (each has its own tables)."""
        return len(self.snrs)

    def step(self, i: int):
        k, s = i % self.pool_steps, i % len(self.snrs)
        return self.steps[s](self.bits[k], noise=self.noise[k])

    def k4_shape(self) -> dict:
        """K4's shape (the search reads RX antenna 0 of every frame, one
        synch symbol a trial), and the detection's."""
        c = self.base
        return dict(batch=self.batch, n=self.n, n_trials=self.n_trials,
                    nfft=c.nfft, cp=c.cp_len, m_synch=self.m_synch,
                    num_data_symb=self.num_patterns * c.synch_dat[1],
                    num_data_bins=c.num_data_bins)

    # -- the check -----------------------------------------------------------
    def answers(self, i: int, out, frames: np.ndarray):
        """The frames ``frames`` of step i's output, on the host: [(key,
        program answer)]."""
        idx = torch.as_tensor(frames, device=self.device)
        host = {f: getattr(out, f).index_select(0, idx).cpu().numpy()
                for f in FIELDS}
        return [((i, int(fr)), {f: host[f][j] for f in FIELDS})
                for j, fr in enumerate(frames)]

    def _inputs(self, key):
        i, fr = key
        k = i % self.pool_steps
        bits = self.bits[k, fr].cpu().numpy().astype(np.int64)
        noise = self.noise[k, fr].cpu().numpy().astype(np.complex128)
        return self.ref_cfgs[i % len(self.snrs)], bits, noise

    def control(self, key) -> dict:
        """The reference one precision below the program's, in its place."""
        cfg, bits, noise = self._inputs(key)
        r = ref.link_frame(cfg, bits, noise, ref.TF32, chan=self.chan)
        return dict(found=r["found"], lock_ptr=r["lock_ptr"],
                    delay_idx=r["delay_idx"], hard_bits=r["hard_bits"],
                    ber=r["ber"], phasors=r["phasors"].numpy(),
                    chan_freq=r["chan_freq"].numpy())

    def judge(self, key, got: dict, limits: dict) -> dict:
        """The numbers one frame gives: decisions that differ from the
        reference's (found, lock, delay, a layer's ber not that of its own
        bits), each layer's hard bits wrong away from a boundary, the
        widest phasor gap and the widest gap of the 2x2 channel estimate."""
        cfg, bits, noise = self._inputs(key)
        tie = limits["tie_share_of_gate"] * ref.gate(cfg)
        follow = (int(got["lock_ptr"]), int(got["delay_idx"]))
        r = ref.link_frame(cfg, bits, noise, follow=follow, tie=tie,
                           chan=self.chan)
        hard = np.asarray(got["hard_bits"])
        ber_own = (hard[:, :bits.shape[-1]] != bits).mean(-1)
        wrong = int(bool(got["found"]) != r["found"])
        wrong += int(np.abs(np.asarray(got["ber"]) - ber_own).max() > 1e-6)
        out = dict(wrong_decisions=0, wrong_bits=0, phasor_gap=0.0,
                   chan_gap=0.0, followed=r["followed"])
        if r["found"] and got["found"]:
            wrong += int(int(got["lock_ptr"]) != r["lock_ptr"])
            wrong += int(int(got["delay_idx"]) != r["delay_idx"])
        if wrong or not r["found"]:
            out["wrong_decisions"] = wrong
            return out
        want = r["phasors"].numpy()
        out["phasor_gap"] = float(np.abs(np.asarray(got["phasors"]) -
                                         want).max())
        out["chan_gap"] = float(np.abs(np.asarray(got["chan_freq"]) -
                                       r["chan_freq"].numpy()).max())
        out["wrong_bits"] = sum(
            judge.wrong_bits(hard[s], r["hard_bits"][s], want[s],
                             limits["phasor_gap"]) for s in range(2))
        return out
