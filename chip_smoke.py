#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the four CUDA
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

Run from the repository root:  python3 chip_smoke.py
Exits non-zero, printing no result, without a CUDA device or outside the
repository.  The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
CHAIN_REPS = 20
CHAIN_ROUNDS = 3              # the chain is timed this often; median kept
TIMING_REPS = 20
CELLS = (("GOLDEN64", 128), ("LTE1024", 32), ("LTE2048", 32))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 66.9e12      # the same: float32 outside the tensor cores
L2_EVICT_BYTES = 256 << 20    # read before each timed launch: > 5x the L2
SLEEP_CLOCK_HZ = 2.0e9        # above the H100's 1.98 GHz boost clock, so a
                              # sleep of t * this many cycles lasts >= t
SOURCES = {   # kernel -> (CUDA source, the TPU kernel's pallas_call)
    "ofdm_mod": ("lte_gnu_radio_code_tpu_torch/csrc/ofdm_mod.cu",
                 "lte_gnu_radio_code_tpu/pallas_kernels/ofdm_mod.py:165"),
    "channel_conv": ("lte_gnu_radio_code_tpu_torch/csrc/channel_conv.cu",
                     "lte_gnu_radio_code_tpu/pallas_kernels/channel_conv.py:91"),
    "sync_search": ("lte_gnu_radio_code_tpu_torch/csrc/sync_search.cu",
                    "lte_gnu_radio_code_tpu/pallas_kernels/sync_search.py:314"),
    "equalize": ("lte_gnu_radio_code_tpu_torch/csrc/equalize.cu",
                 "lte_gnu_radio_code_tpu/pallas_kernels/equalize.py:142"),
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
    float32 operations the function needs on these inputs."""
    k, p = kernel_fn(), plain_fn()
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
    nbytes = sum(x.nbytes for x in inputs) + k.nbytes
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


def sync_checks(cfg, batch, rxs, n_trials, cell) -> dict:
    """K4 at one main-path shape: the route the rule gives it, the kernel
    against the conv-bank twin (timed, with the twin's conv1d alone as the
    library call), against the FFT-form plain version, and all three
    against a float64 evaluation of the FFT form; bytes, operations and
    bound of the function (the operations of its cheapest known form,
    whichever kernel ran), the product form's bound beside it, and the
    other route's kernel timed on the same input."""
    import torch.nn.functional as F
    from lte_gnu_radio_code_tpu_torch.kernels import fft, sync_search
    from lte_gnu_radio_code_tpu_torch.ops import fast_sync
    from lte_gnu_radio_code_tpu_torch.utils.tables import device_table

    kind = sync_search.route(cfg.nfft, cfg.cp_len, cfg.stride, cfg.m_synch)
    want = "direct" if cfg.stride == 1 else "fft"
    if kind != want:
        raise AssertionError(f"{cell}: sync_search route {kind!r}, expected "
                             f"{want!r} at stride {cfg.stride}")
    before = dict(sync_search.route_launches)
    k = sync_search.sync_corr_abs(cfg, rxs, n_trials)
    other = "fft" if kind == "direct" else "direct"
    if (sync_search.route_launches[kind] != before[kind] + 1 or
            sync_search.route_launches[other] != before[other]):
        raise AssertionError(f"{cell}: the wrapper did not launch the "
                             f"{kind} kernel once: {before} -> "
                             f"{sync_search.route_launches}")

    tol = (dict(atol=2e-3) if cfg.stride == 1
           else dict(atol=3e-3, rtol=2e-4))
    # the function needs no more operations than its cheapest form: the
    # FFT form wherever it applies, whichever kernel the rule picks
    direct_ops = sync_search.direct_ops(cfg.nfft, cfg.cp_len, cfg.m_synch)
    least_ops = direct_ops
    if fft.takes_fft(cfg.nfft) and cfg.cp_len + 1 <= cfg.nfft:
        least_ops = min(direct_ops,
                        sync_search.fft_ops(cfg.nfft, cfg.m_synch))
    w = device_table(fast_sync._conv_weights, rxs.device, cfg)
    xr = planar(rxs[:, cfg.cp_len:])
    r = compare(
        "sync_search", lambda: sync_search.sync_corr_abs(cfg, rxs, n_trials),
        lambda: sync_search.sync_corr_abs_plain(cfg, rxs, n_trials), (rxs,),
        ops=float(batch * n_trials * least_ops),
        library_fn=lambda: F.conv1d(xr, w, stride=cfg.stride), **tol)
    r["kernel_route"] = kind
    direct_bound_ms = bound(r["bytes"],
                            float(batch * n_trials * direct_ops))[0]
    r["other_route_ms"] = event_ms(
        lambda: sync_search._launch(other, cfg, rxs, n_trials), TIMING_REPS)
    ko = sync_search._launch(other, cfg, rxs, n_trials)

    twin = sync_search.sync_corr_abs_plain(cfg, rxs, n_trials)
    fplain = sync_search.sync_corr_abs_fft_plain(cfg, rxs, n_trials)
    for what, v in (("FFT-form plain version", fplain),
                    (f"{other} kernel", ko)):
        if not torch.allclose(k, v, **tol):
            raise AssertionError(f"{cell}: sync_search {kind} kernel vs "
                                 f"{what}: max |diff| "
                                 f"{float((k - v).abs().max())} beyond {tol}")
    errs = {"kernel": 0.0, "other": 0.0, "twin": 0.0, "fft_plain": 0.0}
    for i in range(0, batch, 8):      # float64 FFT form, 8 frames at a time
        ref = fast_sync.sync_corr_abs_fft(
            cfg, rxs[i:i + 8].to(torch.complex128), n_trials)
        for key, v in (("kernel", k), ("other", ko), ("twin", twin),
                       ("fft_plain", fplain)):
            errs[key] = max(errs[key],
                            float((v[i:i + 8].double() - ref).abs().max()))
    r["err_vs_float64"] = errs
    r["err_vs_fft_plain"] = float((k - fplain).abs().max())
    print(f"{cell}: sync_search route {kind}: {r['ops']:.4g} operations in "
          f"the cheapest form, {r['bytes']} bytes, bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
          f"({r['bound_share']:.3f} of it reached; the product form's bound "
          f"{direct_bound_ms:.4f} ms, {direct_bound_ms / r['ms']:.3f}); "
          f"{other} kernel on the same input {r['other_route_ms']:.4f} ms; "
          f"max |err| vs float64: {kind} kernel {errs['kernel']:.3e}, "
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


def kernel_checks(cfg, batch, dev, cell) -> dict:
    """Each kernel against its twin on real main-path inputs of one cell."""
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

    corr = sync_search.sync_corr_abs(cfg, rxs, n_trials)
    ptr, delay, _, _, first = sync.first_lock(cfg, corr)
    spec = sync.sync_spectrum_at(cfg, rxs, first, method="dft")
    _, chan_full, _ = sync.estimate_channel(cfg, spec, delay)
    win = equalize.data_windows(cfg, rxs, ptr, num_patterns)
    coeff = equalize.combined_coeff(cfg, delay, chan_full)
    k = win.shape[1]
    win = win.reshape(batch * k, cfg.nfft)
    coeff = coeff[:, None, :].expand(batch, k, -1).reshape(batch * k, -1)
    out["equalize"] = compare(
        "equalize", lambda: equalize.demod_windows(cfg, win, coeff),
        lambda: equalize.demod_windows_plain(cfg, win, coeff), (win, coeff),
        ops=fft_flops(len(win), cfg.nfft) + 12.0 * coeff.numel(),
        library_fn=lambda: torch.fft.fft(win, dim=-1), atol=2e-4)
    for name, r in out.items():
        print(f"{cell}: {name:13s} kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms  "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({r['bound_share']:.3f} reached)  max|err| "
              f"{r['max_abs_err']:.3e} (atol {r['atol']}, rtol {r['rtol']})  "
              f"{r['bytes']} bytes, {r['hbm_share']:.3f} of 3.35 TB/s "
              f"(L2 evicted)")
    return out


def chain_run(cfg, batch, dev, cell) -> dict:
    """The main path: chain_batch with every kernel, reps with the bits
    flipped between reps; then kernel chain vs plain chain on one noise."""
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
    routes0 = dict(sync_search.route_launches)
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
    if float(ber.max()) != 0.0:
        raise AssertionError(f"{cell}: BER {float(ber.max())} != 0")
    missing = [k for k in kernels.KERNEL_MODULES if counts[k] == 0]
    if missing:
        raise AssertionError(f"{cell}: kernels not launched: {missing}")
    routes = {k: v - routes0[k] for k, v in sync_search.route_launches.items()}
    want = "direct" if cfg.stride == 1 else "fft"
    if routes != {"fft": 0, "direct": 0,
                  want: CHAIN_ROUNDS * counts["sync_search"]}:
        raise AssertionError(f"{cell}: sync_search launches by route "
                             f"{routes}, expected all on {want!r}")

    nr = torch.randn(batch, n_samples, generator=gen, device=dev)
    ni = torch.randn(batch, n_samples, generator=gen, device=dev)
    noise = torch.complex(nr, ni)
    rk = chain.chain_batch(cfg, h, n_trials, num_patterns, bits, noise=noise)
    rp = chain.chain_batch(cfg, h, n_trials, num_patterns, bits, noise=noise,
                           plain=True)
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
          f"locked, BER 0; launches {counts}, sync_search by route {routes}; "
          f"kernel vs plain chain: bits "
          f"equal, lock_ptr equal {same_lock}/{batch}, delay equal "
          f"{same_delay}/{batch}")
    busy = profile(step, cell)
    print(f"{cell}: device busy {busy:.3f} of {dt * 1e3 / CHAIN_REPS:.3f} "
          f"ms per step: idle share {1 - busy * CHAIN_REPS / (dt * 1e3):.3f}")
    return {"msps": msps, "ms_per_step": dt * 1e3 / CHAIN_REPS,
            "launches": counts}


def profile(step, cell, reps=3) -> float:
    """Device time per chain step by kernel, from torch.profiler; returns
    the device's busy ms per step."""
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            step(i)
        torch.cuda.synchronize()
    # device kernels only: an operator's row repeats its kernels' time
    rows = sorted(((e.self_device_time_total, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and
                   e.self_device_time_total > 0), reverse=True)
    total = sum(t for t, _ in rows)
    print(f"{cell}: profile of {reps} steps, {len(rows)} device kernels:")
    for t, key in rows[:12]:
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
    return total / reps / 1e3


def cli_check() -> None:
    """The loopback entry point as a user calls it, with no --device: one
    GOLDEN64 frame through the four kernels on the card."""
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.cli import ofdm_chain

    kernels.reset_launch_counts()
    out = ofdm_chain.main(["--json"])
    counts = kernels.launch_counts()
    want = {"found": True, "lock_ptr": 16, "delay_idx": 1, "ber": 0.0}
    if out != want or counts != dict.fromkeys(kernels.KERNEL_MODULES, 1):
        raise AssertionError(f"cli.ofdm_chain: {out} (expected {want}), "
                             f"launches {counts}")
    print(f"cli.ofdm_chain on the card: {out}, launches {counts}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from lte_gnu_radio_code_tpu_torch.kernels import _cuda
    from lte_gnu_radio_code_tpu_torch.utils import params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = card()
    print(f"card: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _cuda.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in _cuda.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  ptxas:", line.strip())

    route_cross_checks(dev)
    cli_check()
    entries = []
    for cfg_name, batch in CELLS:
        cfg = getattr(params, cfg_name)
        cell = f"{cfg_name} b{batch}"
        checks = kernel_checks(cfg, batch, dev, cell)
        run = chain_run(cfg, batch, dev, cell)
        print(f"{cell}: {run['msps']:.3f} Msamples/s on {gpu}")
        for name, c in checks.items():
            src, replaces = SOURCES[name]
            entries.append({"name": f"{name} [{cell}]", "route": "cuda",
                            "source": src, "replaces": replaces,
                            "launches": run["launches"][name],
                            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                            "plain_ms": c["plain_ms"],
                            "bound_ms": c["bound_ms"],
                            "bound_by": c["bound_by"],
                            "library_ms": c["library_ms"],
                            **{k: c[k] for k in (
                                "kernel_route", "other_route_ms",
                                "err_vs_float64", "err_vs_fft_plain")
                               if k in c}})
    print(json.dumps({"kernels": entries}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
