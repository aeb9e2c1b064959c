"""The link entry: ``models/chain.py:chain_batch`` on its kernel path, one
step = one batch of frames at one SNR point (a BER curve).

The inputs are a pool of ``pool_steps`` batches of bits and unit noise
(real and imaginary parts N(0, 1), as ``ops/channel.py:awgn`` takes it),
made on the device from the seed; step i takes pool entry i mod
``pool_steps`` at SNR point i mod len(``snr_db``).  An answer is one
frame: found, lock_ptr, delay_idx, hard_bits, ber and phasors, held to the
reference's TX, channel, AWGN (the same noise) and RX of the same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import judge
from ..reference import vector
from ..reference.numerology import RefConfig

FIELDS = ("found", "lock_ptr", "delay_idx", "hard_bits", "ber", "phasors")


class Entry:
    loop = "closed"

    def __init__(self, config: dict, traffic: dict, device):
        from lte_gnu_radio_code_tpu_torch.models import chain, rxofdm
        from lte_gnu_radio_code_tpu_torch.utils.params import OFDMConfig

        self._chain = chain
        names = {f.name for f in dataclasses.fields(OFDMConfig)}
        kw = {k: v for k, v in config.items() if k in names}
        kw["synch_dat"] = tuple(kw["synch_dat"])
        base = OFDMConfig(**kw).validate()
        self.device = device
        self.batch = int(traffic["frames"])
        self.pool_steps = int(traffic["pool_steps"])
        self.snrs = [float(s) for s in traffic["snr_db"]]
        self.cfgs = [dataclasses.replace(base, snr_db=s).validate()
                     for s in self.snrs]
        self.ref_cfgs = [RefConfig.from_keywords(dict(kw, snr_db=s))
                         for s in self.snrs]
        self.n = base.frame_len + base.nfft - 1
        self.n_trials, self.num_patterns = rxofdm.plan_rx(base, self.n)
        self.h = chain.loopback_taps(base)
        self.base = base
        self.samples_per_step = self.batch * self.n
        self.answers_per_step = self.batch
        self.strata = len(self.snrs)      # the check keeps every SNR point
        self.bits = self.noise = None

    def make_inputs(self, seed: int) -> None:
        """The pool, in two calls of one generator on the device."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        shape = (self.pool_steps, self.batch)
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
        return self._chain.chain_batch(
            self.cfgs[s], self.h, self.n_trials, self.num_patterns,
            self.bits[k], noise=self.noise[k])

    def k4_shape(self) -> dict:
        c = self.base
        return dict(batch=self.batch, n=self.n, n_trials=self.n_trials,
                    nfft=c.nfft, cp=c.cp_len, m_synch=c.m_synch)

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
        x = vector.received(cfg, bits[None], noise[None], vector.TF32)[0]
        r = vector.rx_frame(cfg, x, vector.TF32)
        hard = np.zeros(cfg.num_bits, np.int64)
        ph = np.zeros((cfg.num_data_symb, cfg.num_data_bins), complex)
        if r["found"]:
            hard[:len(r["hard_bits"])] = r["hard_bits"]
            ph = r["phasors"]
        return dict(found=r["found"], lock_ptr=r.get("lock_ptr", 0),
                    delay_idx=r.get("delay_idx", 0), hard_bits=hard,
                    ber=float(np.mean(hard != bits)), phasors=ph)

    def judge(self, key, got: dict, limits: dict) -> dict:
        """The numbers one frame gives: decisions that differ from the
        reference's, its hard bits wrong away from a boundary, and the
        widest phasor gap, over the data symbols inside the buffer."""
        cfg, bits, noise = self._inputs(key)
        x = vector.received(cfg, bits[None], noise[None])[0]
        tie = limits["tie_share_of_gate"] * vector.gate(cfg)
        follow = (int(got["lock_ptr"]), int(got["delay_idx"]))
        ref = vector.rx_frame(cfg, x, follow=follow, tie=tie)
        hard = np.asarray(got["hard_bits"])
        ber_own = float(np.mean(hard[:len(bits)] != bits))
        wrong = int(bool(got["found"]) != ref["found"])
        wrong += int(abs(float(got["ber"]) - ber_own) > 1e-6)
        out = dict(wrong_decisions=0, wrong_bits=0, phasor_gap=0.0,
                   followed=ref["followed"])
        if ref["found"] and got["found"]:
            wrong += int(int(got["lock_ptr"]) != ref["lock_ptr"])
            wrong += int(int(got["delay_idx"]) != ref["delay_idx"])
        if wrong or not ref["found"]:
            out["wrong_decisions"] = wrong
            return out
        rows = ref["in_buf"]
        ph = np.asarray(got["phasors"]).reshape(ref["phasors"].shape)
        out["phasor_gap"] = float(np.abs(ph[rows] - ref["phasors"][rows]
                                         ).max(initial=0.0))
        per_row = 2 * cfg.num_data_bins
        hard_rows = hard[:cfg.num_data_symb * per_row].reshape(-1, per_row)
        want = ref["hard_bits"].reshape(-1, per_row)
        out["wrong_bits"] = judge.wrong_bits(
            hard_rows[rows], want[rows], ref["phasors"][rows],
            limits["phasor_gap"])
        return out
