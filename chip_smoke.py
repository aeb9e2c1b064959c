#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the four CUDA
kernels, holds each against its plain PyTorch twin at the main path's
shapes, then drives the loopback chain (``models.chain.chain_batch``) at
GOLDEN64 batch 128 and LTE1024 batch 32 and checks every frame locks with
BER 0, that every kernel launched, and that the kernel chain's bits equal
the plain chain's on the same noise.

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
TIMING_REPS = 20
CELLS = (("GOLDEN64", 128), ("LTE1024", 32))
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


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, kernel_fn, plain_fn, atol, rtol=0.0) -> dict:
    """Kernel vs plain twin on the same inputs, then timed in turns
    (plain, kernel, kernel, plain)."""
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
    return {"max_abs_err": err, "ms": (t[1] + t[2]) / 2,
            "plain_ms": (t[0] + t[3]) / 2, "atol": atol, "rtol": rtol}


def kernel_checks(cfg, batch, dev, cell) -> dict:
    """Each kernel against its twin on real main-path inputs of one cell."""
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
        "ofdm_mod", lambda: ofdm_mod._mod_rows(cfg, rows, w),
        lambda: ofdm_mod.mod_rows_plain(cfg, rows, w), atol=2e-5)
    tx = ofdm_mod._mod_rows(cfg, rows, w).reshape(batch, cfg.frame_len)

    out["channel_conv"] = compare(
        "channel_conv",
        lambda: channel_conv.apply_channel_frames(tx, h, cfg.nfft),
        lambda: channel_conv.apply_channel_frames_plain(tx, h, cfg.nfft),
        atol=1e-5)
    clean = channel_conv.apply_channel_frames(tx, h, cfg.nfft)
    sig_pow = ((tx - tx.mean(1, keepdim=True)).abs() ** 2).mean(1)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rxs = channel.awgn(cfg, clean, sig_pow[:, None], generator=gen)

    tol = (dict(atol=2e-3) if cfg.stride == 1
           else dict(atol=3e-3, rtol=2e-4))
    out["sync_search"] = compare(
        "sync_search", lambda: sync_search.sync_corr_abs(cfg, rxs, n_trials),
        lambda: sync_search.sync_corr_abs_plain(cfg, rxs, n_trials), **tol)

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
        lambda: equalize.demod_windows_plain(cfg, win, coeff), atol=2e-4)
    for name, r in out.items():
        print(f"{cell}: {name:13s} kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  max|err| {r['max_abs_err']:.3e} "
              f"(atol {r['atol']}, rtol {r['rtol']})")
    return out


def chain_run(cfg, batch, dev, cell) -> dict:
    """The main path: chain_batch with every kernel, reps with the bits
    flipped between reps; then kernel chain vs plain chain on one noise."""
    from lte_gnu_radio_code_tpu_torch import kernels
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
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    results = [step(i) for i in range(CHAIN_REPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    ber = torch.stack([r.ber for r in results])
    found = torch.stack([r.found for r in results])
    if results[0].hard_bits.shape != (batch, cfg.num_bits):
        raise AssertionError(f"hard bits {tuple(results[0].hard_bits.shape)}")
    if not bool(found.all()):
        raise AssertionError(f"{cell}: {int((~found).sum())} frames unlocked")
    if float(ber.max()) != 0.0:
        raise AssertionError(f"{cell}: BER {float(ber.max())} != 0")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"{cell}: kernels not launched: {missing}")

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
    print(f"{cell}: chain_batch x{CHAIN_REPS}: {dt * 1e3 / CHAIN_REPS:.3f} "
          f"ms/step, {msps:.3f} Msamples/s, all {CHAIN_REPS * batch} frames "
          f"locked, BER 0; launches {counts}; kernel vs plain chain: bits "
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
    return total / reps / 1e3


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
                            "plain_ms": c["plain_ms"]})
    print(json.dumps({"kernels": entries}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
