"""The tracker's plain reference: the reference's tracking synchroniser
(``RxBasebandSystem.param_est_synch`` :91-274 and ``rx_data_demod``
:276-309, as the port's NumPy oracle ``reference_cpu/tracker.py`` writes
them out) rewritten line for line in plain torch, float64 on the CPU, as
one chunk step over a state that can be handed in.  It loads nothing of
the program: the numerology is ``reference/numerology.py``'s, the ZC
sequence and the QPSK bits ``reference/golden.py``'s.

The state machine keeps the reference's quirks: stride ceil(cp/2), start
sample cp - 5, delay = argmax - 1 of the +j-signed delay matrix, the
+cp/2 re-adjustment without re-reading the window, the refractory test
against the last accepted pointer, the (1 + 1/SNR) regulariser of the
channel estimate, the min(corr_obs, 5)-entry history and the drift
prediction ceil(fit - cp/4).  Three rules the literal oracle leaves open
are fixed here, as a receiver on a stream states them
(``runtime/stream.py`` of the program):

* Fire or stall: a step reads its window only where its synch windows end
  before ``fire_limit`` and start at or after the segment's first sample;
  elsewhere the state waits, unchanged, for the next chunk.
* The fit is exact.  The oracle's ``np.linalg.lstsq`` on global indices
  rounds, and where the fitted value is an integer (every fit of a drift-
  free stream) its ceiling lands on either side.  Here the five sums are
  taken on differences from the newest entry (x in patterns, y in
  samples), integers that float64 holds exactly, and the one quotient
  rounds once, so ceil(fit - cp/4) is the exact ceiling.  ``b`` is
  computed from the history; a state's own fit is never read.
* The data demod is the receiver's: each data symbol's equalised row
  scaled to unit mean power (the oracle divides row p * nd + sym by the
  power of row p), derotated by delay + 1, and marked outside the real
  samples where its window reaches past them.

Every function takes an :class:`Arith`: ``FLOAT64`` is the reference,
``TF32`` the control (every operand of a transform or product rounded to
TF32's 10-bit mantissa, everything in complex64), whose answers a check
must refuse.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from . import golden
from .numerology import RefConfig, used_bins

HISTORY = 5


@dataclasses.dataclass(frozen=True)
class Arith:
    name: str

    @property
    def dtype(self) -> torch.dtype:
        return torch.complex128 if self.name == "float64" else torch.complex64

    def q(self, x) -> torch.Tensor:
        """x as this arithmetic's complex operand."""
        x = torch.as_tensor(x).to(self.dtype)
        if self.name == "float64":
            return x
        return torch.complex(_tf32(x.real), _tf32(x.imag))


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest even at TF32's 10 mantissa bits."""
    u = a.contiguous().to(torch.float32).view(torch.int32).to(torch.int64)
    u = (u + 0x0FFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


FLOAT64 = Arith("float64")
TF32 = Arith("tf32")


@contextlib.contextmanager
def _no_tf32():
    """TF32 off in torch's matmul and cuDNN while the reference computes,
    and the settings as they were after it."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


@dataclasses.dataclass
class State:
    """One stream's tracker state, the oracle's loop variables: the loop
    count, corr_obs (-1 searching, else detections - 1), the last fired
    pointer, the search adjustment, the detections (sym_count), the last
    accepted pointer, and the history of (sym_count * pattern, ptr +
    delay), entry sym_count mod 5."""
    loop_count: int = 0
    corr_obs: int = -1
    ptr_frame: int = 0
    ptr_adj: int = 0
    sym_count: int = 0
    last_ptr: int = 0
    hx: list = dataclasses.field(default_factory=lambda: [0] * HISTORY)
    hy: list = dataclasses.field(default_factory=lambda: [0] * HISTORY)


@dataclasses.dataclass
class Detection:
    ptr: int                # global pointer
    delay: int              # argmax - 1
    peak: float
    chan: torch.Tensor      # [nfft]


class Tables:
    """The cell's constants in one arithmetic."""

    def __init__(self, cfg: RefConfig, ar: Arith = FLOAT64):
        self.cfg, self.ar = cfg, ar
        nfft = cfg.nfft
        self.synch_bins = torch.as_tensor(
            np.asarray(used_bins(nfft, cfg.num_synch_bins)[1]))
        self.data_bins = torch.as_tensor(
            np.asarray(used_bins(nfft, cfg.num_data_bins)[1]))
        self.zc = torch.as_tensor(golden.zc_for_config(cfg))
        # [m0 L, cp + 1] exp(+j 2 pi k d / nfft): the oracle's p_mat
        p = torch.exp(1j * 2 * (math.pi / nfft) * torch.outer(
            self.synch_bins.to(torch.float64),
            torch.arange(cfg.cp_len + 1, dtype=torch.float64)))
        self.p_mat = p.repeat(cfg.m_synch, 1)
        self.snr = cfg.snr_linear
        # a step's reach: its synch windows, from its pointer
        self.span = (cfg.m_synch - 1) * cfg.rx_b_len + nfft


def stride(cfg: RefConfig) -> int:
    return int(math.ceil(cfg.cp_len / 2))


def fit_next(st: State, pattern: int, n_eff: int = HISTORY) -> float:
    """The least-squares line through the history entries i < n_eff at
    the next entry's x (sym_count * pattern), less the newest entry's y:
    the normal equations on differences from the newest entry, x in
    patterns; every sum an integer, exact in float64, one rounding in the
    quotient."""
    k = (st.sym_count - 1) % HISTORY
    u = torch.tensor([(st.hx[i] - st.hx[k]) // pattern for i in range(n_eff)],
                     dtype=torch.float64)
    v = torch.tensor([st.hy[i] - st.hy[k] for i in range(n_eff)],
                     dtype=torch.float64)
    s0, s1, s2 = float(n_eff), u.sum(), (u * u).sum()
    sy, sxy = v.sum(), (u * v).sum()
    det = s0 * s2 - s1 * s1
    u_next = (st.sym_count * pattern - st.hx[k]) // pattern
    return float((s2 * sy - s1 * sxy + u_next * (s0 * sxy - s1 * sy)) / det)


def pointer(cfg: RefConfig, st: State) -> int:
    """This step's pointer: search by stride, nominal advance, or the
    drift prediction from the history."""
    if st.corr_obs == -1:
        return st.loop_count * stride(cfg) + (cfg.cp_len - 4) - 1 + st.ptr_adj
    if st.corr_obs < 5:
        return st.ptr_frame + cfg.pattern_len * cfg.rx_b_len
    newest = st.hy[(st.sym_count - 1) % HISTORY]
    return newest + int(math.ceil(fit_next(st, cfg.pattern_len) -
                                  cfg.cp_len / 4))


def correlate(tab: Tables, x: torch.Tensor, local: int):
    """The oracle's ``correlate``: the m_synch windows at x[local], their
    synch-bin spectrum normalised to unit mean power, and |conj(zc) @ (sd
    p_mat)| over the cp + 1 delays.  Returns (sd, |corr| [cp + 1])."""
    cfg, ar = tab.cfg, tab.ar
    starts = local + cfg.rx_b_len * torch.arange(cfg.m_synch)
    win = x[starts[:, None] + torch.arange(cfg.nfft)]
    sd0 = torch.fft.fft(ar.q(win), dim=-1)[:, tab.synch_bins].reshape(-1)
    pow_est = (sd0 * sd0.conj()).real.sum() / sd0.numel()
    sd = sd0 / torch.sqrt(pow_est)
    dd = (ar.q(tab.zc.conj()) @ (ar.q(sd)[:, None] * ar.q(tab.p_mat))).abs()
    return sd, dd


def step(tab: Tables, x: torch.Tensor, x_start: int, fire_limit: int,
         st: State, max_steps: int, follow=None, tie: float = 0.0):
    """The tracker over segment x (x[0] at global ``x_start``) from state
    ``st``: up to ``max_steps`` steps, stopping at the first that does not
    fire (its state is the next chunk's).  ``follow`` lists the program's
    accepted (ptr, delay) in order; where the reference's choice at the
    same pointer is within ``tie`` of the program's (the gate for a search
    step, the program's delay's |corr| against the peak), the reference
    takes the program's.  Returns (the state after, the detections, the
    decisions followed, the steps that fired)."""
    st = dataclasses.replace(st, hx=list(st.hx), hy=list(st.hy))
    prog = None if follow is None else list(follow)
    dets, followed, fired = [], 0, 0
    with _no_tf32():
        for _ in range(max_steps):
            ptr = pointer(tab.cfg, st)
            if not (tab.span + ptr < fire_limit and ptr >= x_start):
                break
            fired += 1
            followed += _decide(tab, x, x_start, st, ptr, dets, prog, tie)
    return st, dets, followed, fired


def _decide(tab: Tables, x, x_start: int, st: State, ptr: int, dets: list,
            prog, tie: float) -> int:
    """One step that fires, on ``st`` in place (the oracle's loop body);
    returns the decisions it took from the program's list ``prog``."""
    cfg = tab.cfg
    nfft, cp, m0 = cfg.nfft, cfg.cp_len, cfg.m_synch
    gate = 0.5 * m0 * cfg.num_synch_bins
    sd, dd = correlate(tab, x, ptr - x_start)
    dmax, arg = float(dd.max()), int(dd.argmax())
    crossed, took = dmax > gate, 0
    theirs = prog[0] if prog else None
    if theirs is not None and theirs[0] == ptr:
        want = theirs[1] + 1
        if st.corr_obs == -1 and not crossed and dmax > gate - tie:
            crossed, took = True, took + 1
        if 0 <= want <= cp and want != arg and float(dd[want]) >= dmax - tie:
            arg, took = want, took + 1
    elif prog is not None and st.corr_obs == -1 and crossed and \
            dmax <= gate + tie:
        crossed, took = False, took + 1
    dind = arg - 1
    if crossed or st.corr_obs > -1:
        if dind > math.ceil(0.75 * cp):
            if st.corr_obs == 0:
                st.ptr_adj += int(math.ceil(0.5 * cp))
                ptr = st.loop_count * stride(cfg) + (cp - 4) - 1 + st.ptr_adj
            elif 0 < st.corr_obs < 5:
                ptr += int(math.ceil(0.5 * cp))
        refr = 0 if st.corr_obs == 0 else st.last_ptr
        if ptr - refr > 2 * cp + nfft or st.corr_obs == -1:
            st.corr_obs += 1
            k = st.sym_count % HISTORY
            st.hy[k] = ptr + dind
            st.hx[k] = st.sym_count * cfg.pattern_len
            st.sym_count += 1
            st.last_ptr = ptr
            data_recov0 = sd * tab.ar.q(tab.p_mat[:, dind + 1])
            tmp = (data_recov0 * tab.ar.q(tab.zc.conj())) / (1 + 1 / tab.snr)
            h1 = torch.zeros(nfft, dtype=tab.ar.dtype)
            h1[tab.synch_bins] = tmp.reshape(m0, -1).sum(0) / m0
            dets.append(Detection(ptr, dind, dmax, h1))
            if theirs is not None and theirs[0] == ptr:
                prog.pop(0)
    st.loop_count += 1
    st.ptr_frame = ptr
    return took


def demod(tab: Tables, x: torch.Tensor, x_start: int, real_end: int,
          dets: list):
    """The data symbols of each detection (``rx_data_demod``): symbol j at
    ptr + (j + 1) (nfft + cp), its data-bin spectrum normalised to unit
    power, derotated by delay + 1, equalised by conj(h) / (|h|^2 + 1/snr),
    then scaled to unit mean power; ok where its window lies in the real
    samples (global < ``real_end``).  Returns (phasors [k, nd,
    num_data_bins], ok [k, nd], hard bits [k, nd, 2 num_data_bins])."""
    cfg, ar = tab.cfg, tab.ar
    nfft, nd, nb = cfg.nfft, cfg.synch_dat[1], cfg.num_data_bins
    k = len(dets)
    ph = torch.zeros(k, nd, nb, dtype=ar.dtype)
    ok = torch.zeros(k, nd, dtype=torch.bool)
    db = tab.data_bins
    with _no_tf32():
        for p, d in enumerate(dets):
            rot = torch.exp(1j * 2 * (math.pi / nfft) *
                            db.to(torch.float64) * (d.delay + 1))
            h = d.chan[db]
            coeff = ar.q(h.conj() / (h.conj() * h + 1 / tab.snr))
            for sym in range(nd):
                start = d.ptr + (sym + 1) * cfg.rx_b_len
                if start + nfft > real_end:
                    continue
                f = torch.fft.fft(ar.q(x[start - x_start:
                                         start - x_start + nfft]))[db]
                f = f / torch.sqrt((f * f.conj()).real.sum() / nb)
                eq = ar.q(f * ar.q(rot)) * coeff
                ph[p, sym] = eq / torch.sqrt((eq * eq.conj()).real.mean())
                ok[p, sym] = True
    if not k:
        return ph, ok, torch.zeros(0, nd, 2 * nb, dtype=torch.int64)
    hard = golden.bit_recovery(ph.to(torch.complex128).numpy())[0]
    return ph, ok, torch.as_tensor(hard).reshape(k, nd, -1)


def track(cfg: RefConfig, x, ar: Arith = FLOAT64, max_steps: int | None = None):
    """The tracker over one whole buffer from an empty state: (state,
    detections, phasors, ok, hard bits), as ``step`` and ``demod`` give
    them with every window inside x."""
    x = torch.as_tensor(np.asarray(x)).to(torch.complex128)
    tab = Tables(cfg, ar)
    n = x.shape[0]
    st, dets, _, _ = step(tab, x, 0, n, State(),
                          max_steps or n // stride(cfg) + 2)
    ph, ok, hard = demod(tab, x, 0, n, dets)
    return st, dets, ph, ok, hard
