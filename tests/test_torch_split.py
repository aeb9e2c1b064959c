"""The split RX of the PyTorch port (``models/split.py``) on the CPU: the
sync-index finder and the channel estimate + demod against the JAX
package's on one buffer made from a seed, and split == monolithic.

Exact: detection table, lock, delay, hard bits.  Within tolerance: peaks
2e-3, phasors and the channel 2e-4 (the JAX package's own)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lte_gnu_radio_code_tpu.models import split as jsplit
from lte_gnu_radio_code_tpu.utils.params import GOLDEN64
from lte_gnu_radio_code_tpu_torch import kernels
from lte_gnu_radio_code_tpu_torch.kernels import _cuda
from lte_gnu_radio_code_tpu_torch.models import rxofdm, split
from torch_parity import port_cfg, recorded_launch, reduced, rx_buffer

S31 = reduced(GOLDEN64, nfft=128, cp_len=32, num_synch_bins=126,
              num_data_bins=120, num_ofdm_symb=24, stride=31)


@pytest.mark.parametrize("seed,snr_db", [(21, 25.0), (23, 15.0),
                                         (24, 40.0)])
@pytest.mark.parametrize("cfg", [GOLDEN64, S31], ids=["golden64", "stride31"])
def test_split_stages_equal_jax_and_monolithic(cfg, seed, snr_db):
    """On the CPU (K4's and K2's twins) at three seeds and SNRs."""
    pcfg = port_cfg(cfg)
    rx, bits = rx_buffer(cfg, seed, snr_db=snr_db)
    jf1, jf2 = jsplit.make_split_rx(cfg, len(rx))
    f1, f2 = split.make_split_rx(pcfg, len(rx), device="cpu")
    a, ja = f1(rx), jf1(jnp.asarray(rx))
    n = int(ja.count)
    assert int(a.count) == n == cfg.num_patterns
    assert a.ptrs.dtype == a.delays.dtype == torch.int32
    assert a.peaks.dtype == torch.float32
    np.testing.assert_array_equal(a.passthrough, rx)
    np.testing.assert_array_equal(a.ptrs, np.asarray(ja.ptrs))
    np.testing.assert_array_equal(a.delays, np.asarray(ja.delays))
    np.testing.assert_allclose(a.peaks, np.asarray(ja.peaks), atol=2e-3,
                               rtol=0)

    b = f2(a.passthrough, a.ptrs[0], a.delays[0])
    jb = jf2(ja.passthrough, ja.ptrs[0], ja.delays[0])
    np.testing.assert_allclose(b.phasors, np.asarray(jb.phasors), atol=2e-4,
                               rtol=0)
    np.testing.assert_allclose(b.chan_freq, np.asarray(jb.chan_freq),
                               atol=2e-4, rtol=0)
    np.testing.assert_array_equal(b.hard_bits, np.asarray(jb.hard_bits))

    mono = rxofdm.make_rx(pcfg, len(rx))(torch.from_numpy(rx))
    assert (int(a.ptrs[0]), int(a.delays[0])) == (int(mono.lock_ptr),
                                                  int(mono.delay_idx))
    assert torch.equal(b.hard_bits, mono.hard_bits)
    torch.testing.assert_close(b.phasors, mono.phasors, atol=2e-6, rtol=0)
    assert float((b.hard_bits.numpy() != bits).mean()) < 0.01


def test_split_on_noise_finds_nothing():
    rng = np.random.default_rng(3)
    x = 0.05 * (rng.standard_normal(5000) + 1j * rng.standard_normal(5000))
    f1, _ = split.make_split_rx(port_cfg(GOLDEN64), 5000, device="cpu")
    a = f1(x)
    assert int(a.count) == 0 and not bool(a.ptrs.any())


def test_split_runs_on_the_card_unless_asked(monkeypatch):
    """Without a device the pair runs on the CUDA device, and raises where
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            split.make_split_rx(port_cfg(GOLDEN64), 5000, **kw)


def test_split_kernel_path_launches_k4_then_k2(monkeypatch):
    """The CUDA branches with the launches recorded instead of made: stage
    A is one K4 launch (the direct route at GOLDEN64), stage B one K2
    launch over the frame's data windows."""
    calls = []

    class Library:
        @staticmethod
        def sync_search_direct_fits(*args):
            return 1

    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "library", Library)
    monkeypatch.setattr(_cuda, "launch", recorded_launch(calls))
    cfg = GOLDEN64
    rx, _ = rx_buffer(cfg, 22)
    f1, f2 = split.make_split_rx(port_cfg(cfg), len(rx), device="cpu")
    kernels.reset_launch_counts()
    a = f1(rx)
    f2(a.passthrough, 16, 1)
    assert [name for name, _ in calls] == ["sync_search_direct",
                                           "equalize_fft"]
    demod = calls[1][1]
    assert demod[4] == 0                      # one coefficient row for all
    assert demod[6:9] == (cfg.num_data_symb, cfg.nfft, cfg.num_data_bins)
    counts = kernels.launch_counts()
    assert counts["sync_search"] == counts["equalize"] == 1
    kernels.reset_launch_counts()
