"""The FFT kernels of K1 and K2 on the CPU: the radix plan and twiddle
table that the wrappers hand to ``csrc/fft.cuh``, run through the kernels'
own Stockham stage in numpy, against np.fft; the shape rule on nfft; and
the int32 bin tables.  The kernels themselves are held to their twins
on a CUDA device by tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

from lte_gnu_radio_code_tpu_torch import kernels
from lte_gnu_radio_code_tpu_torch.kernels import (_cuda, equalize, fft,
                                                  ofdm_mod)
from lte_gnu_radio_code_tpu_torch.utils.params import (GOLDEN64, LTE1024,
                                                       LTE2048, used_bins)

POW2 = [16, 32, 64, 128, 256, 512, 1024, 2048, 4096]


def stockham(x, inverse=False):
    """The stages of ``fft.plan(len(x))`` as ``csrc/fft.cuh:stage`` runs
    them, in complex64, reading w^(j k) from ``fft.twiddles``."""
    n = len(x)
    tw = fft.twiddles(n)
    a, p = x.astype(np.complex64), 1
    for r in fft.plan(n):
        m, step = n // r, n // (p * r)
        i = np.arange(m)
        k = i & (p - 1)
        xs = [a[i + j * m] * (np.conj(tw[j * k * step]) if inverse
                              else tw[j * k * step]) for j in range(r)]
        if r == 2:
            y = [xs[0] + xs[1], xs[0] - xs[1]]
        else:
            a0, a1 = xs[0] + xs[2], xs[0] - xs[2]
            a2, a3 = xs[1] + xs[3], xs[1] - xs[3]
            b = (1j if inverse else -1j) * a3
            y = [a0 + a2, a1 + b, a0 - a2, a1 - b]
        a = np.empty_like(a)
        for j in range(r):
            a[(i - k) * r + k + j * p] = y[j]
        p *= r
    assert p == n
    return a


@pytest.mark.parametrize("nfft", POW2)
def test_plan_and_twiddles_give_numpy_fft(nfft):
    rng = np.random.default_rng(nfft)
    tw = fft.twiddles(nfft)
    assert tw.dtype == np.complex64 and tw.shape == (nfft,)
    np.testing.assert_allclose(
        tw, np.exp(-2j * np.pi * np.arange(nfft) / nfft), rtol=0, atol=6e-8)
    x = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    x = x.astype(np.complex64)
    for inverse, ref in ((False, np.fft.fft(x.astype(np.complex128))),
                         (True, np.fft.ifft(x.astype(np.complex128)) * nfft)):
        got = stockham(x, inverse)
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err < 2e-6, (inverse, err)


def test_plan_is_radix4_then_one_radix2():
    assert fft.plan(16) == (4, 4)
    assert fft.plan(64) == (4, 4, 4)
    assert fft.plan(2048) == (4, 4, 4, 4, 4, 2)
    for n in POW2:
        assert int(np.prod(fft.plan(n))) == n


@pytest.mark.parametrize("nfft,fft_route", [
    *[(n, True) for n in POW2],
    (8, False), (8192, False), (96, False), (1000, False), (1536, False)])
def test_route_rule(nfft, fft_route):
    assert fft.takes_fft(nfft) is fft_route
    if fft_route:
        fft.require(nfft)
    else:
        for f in (fft.require, fft.plan):
            with pytest.raises(ValueError):
                f(nfft)


@pytest.mark.parametrize("cfg", [GOLDEN64, LTE1024, LTE2048],
                         ids=["golden64", "lte1024", "lte2048"])
def test_bin_tables_are_used_bins(cfg):
    _, wrapped = used_bins(cfg.nfft, cfg.num_data_bins)
    k2 = equalize._bin_index(cfg.nfft, cfg.num_data_bins)
    assert k2.dtype == np.int32
    np.testing.assert_array_equal(k2, wrapped)
    signed, _ = used_bins(cfg.nfft, cfg.num_data_bins)
    k1 = ofdm_mod._bin_index(cfg.nfft, signed)
    assert k1.dtype == np.int32
    np.testing.assert_array_equal(k1, wrapped)


@pytest.mark.parametrize("nfft,takes", [(64, True), (96, False),
                                        (1024, True)])
def test_wrappers_launch_by_the_shape_rule(monkeypatch, nfft, takes):
    """The wrappers' CUDA branch, with the launch recorded instead of run:
    a power-of-two nfft launches the FFT kernels, with as many arguments as
    their C signatures and each launch counted; any other raises
    ValueError and launches nothing."""
    cfg = dataclasses.replace(GOLDEN64, nfft=nfft, cp_len=nfft // 4)
    calls = []
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "launch",
                        lambda name, dev, *args: calls.append((name, args)))
    kernels.reset_launch_counts()
    rows = torch.zeros(5 * nfft + 1, dtype=torch.complex64)[1:].view(5, nfft)
    assert rows.data_ptr() % 16 == 8       # a view that starts off 16 bytes
    vals = torch.zeros(5, cfg.num_data_bins, dtype=torch.complex64)
    _, bins = used_bins(nfft, cfg.num_data_bins)
    wrappers = (lambda: ofdm_mod.modulate_rows(cfg, rows),
                lambda: ofdm_mod.modulate_data_vals(cfg, vals, bins),
                lambda: equalize.demod_windows(cfg, rows, vals))
    for run in wrappers:
        if takes:
            run()
        else:
            with pytest.raises(ValueError):
                run()
    counts = kernels.launch_counts()
    if not takes:
        assert calls == [] and not any(counts.values()), counts
        return
    assert [n for n, _ in calls] == ["ofdm_mod_fft"] * 2 + ["equalize_fft"]
    assert calls[0][1][1] is None and calls[1][1][1] is not None
    for name, args in calls:
        assert len(args) + 1 == len(_cuda.SIGNATURES[name]), name
    # 16-byte loads get a copy
    assert calls[0][1][0] % 16 == 0 and calls[2][1][0] % 16 == 0
    assert counts == {**dict.fromkeys(kernels.KERNEL_MODULES, 0),
                      "ofdm_mod": 2, "equalize": 1}
    kernels.reset_launch_counts()


def test_k2_wrapper_rejects_odd_bin_count(monkeypatch):
    """used_bins drops one of an odd count: the CUDA route refuses it
    rather than read past the bin table."""
    cfg = dataclasses.replace(GOLDEN64, num_data_bins=59)
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "launch", lambda *a: None)
    with pytest.raises(ValueError):
        equalize.demod_windows(cfg, torch.zeros(4, 64, dtype=torch.complex64),
                               torch.zeros(59, dtype=torch.complex64))
