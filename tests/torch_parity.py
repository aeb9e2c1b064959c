"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: configuration conversion and seeded inputs."""

import ctypes
import dataclasses

import numpy as np

from lte_gnu_radio_code_tpu.reference_cpu import golden as G
from lte_gnu_radio_code_tpu_torch.utils import params as tparams


def port_cfg(cfg):
    """The port's OFDMConfig with the same fields as a JAX-package one."""
    return tparams.OFDMConfig(**dataclasses.asdict(cfg))


def reduced(cfg, **changes):
    return dataclasses.replace(cfg, **changes).validate()


def recorded_launch(calls):
    """A stand-in for ``kernels/_cuda.py:launch`` on CPU tensors: appends
    (entry point, arguments) to calls and runs nothing, except that K4's
    peaks form (its last argument, the delay buffer, not null) gets delay 0
    for every trial, since its caller reads that output as indices."""
    def launch(name, dev, *args):
        calls.append((name, args))
        if name.startswith("sync_search") and args[-1]:
            ctypes.memset(args[-1], 0, args[1] * args[6] * 4)
    return launch


def rx_buffer(cfg, seed, snr_db=None):
    """One seeded frame through the numpy oracle TX and the Fading channel
    (+ AWGN at snr_db), complex64, with its bits."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, cfg.num_bits)
    tx = G.tx_frame(cfg, bits)
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=cfg.nfft)
    if snr_db is not None:
        rx = G.awgn(dataclasses.replace(cfg, snr_db=snr_db), rx, rng,
                    np.var(tx))
    return rx.astype(np.complex64), bits


def jax_rx_buffer(cfg, seed, snr_db=None):
    """One seeded frame of any modulation and pilot grid through the JAX
    package's TX and the numpy Fading channel (+ AWGN at snr_db), complex64,
    with its bits: the buffer both packages' receivers are given."""
    import jax.numpy as jnp

    from lte_gnu_radio_code_tpu.models import txofdm as jtx

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, cfg.num_bits)
    tx = np.asarray(jtx.tx_frame(cfg, jnp.asarray(bits, jnp.int32)))
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=cfg.nfft)
    if snr_db is not None:
        rx = G.awgn(dataclasses.replace(cfg, snr_db=snr_db), rx, rng,
                    np.var(tx))
    return rx.astype(np.complex64), bits


def decision_margin(phasors, modulation):
    """Distance of every phasor component to its nearest decision boundary,
    [..., 2] (real, imaginary).  QPSK decides on the sign; Gray QAM on the
    sign and on the midpoints between the PAM levels."""
    levels = {"QPSK": 1, "QAM16": 2, "QAM64": 4}[modulation]
    m = 2 * levels
    scale = 1.0 if modulation == "QPSK" else np.sqrt(2.0 * (m * m - 1) / 3.0)
    bounds = np.arange(-(levels - 1), levels) * 2.0 / scale
    comp = np.stack([np.real(phasors), np.imag(phasors)], -1)
    return np.abs(comp[..., None] - bounds).min(-1)


def assert_bits_equal_or_on_boundary(ours, ref, phasors, cfg, tol):
    """Hard bits [n_symbols * bits_per_bin] equal to the JAX package's; a
    bit may differ only in a symbol whose JAX phasor lies within ``tol``
    (the phasor tolerance) of a decision boundary.  Returns how many do."""
    bps = cfg.bits_per_bin
    differ = (np.asarray(ours).reshape(-1, bps) !=
              np.asarray(ref).reshape(-1, bps)).any(-1)
    margin = decision_margin(np.asarray(phasors).reshape(-1),
                             cfg.modulation).min(-1)
    assert not (differ & (margin > tol)).any(), (
        f"{int(differ.sum())} symbols differ, "
        f"{int((differ & (margin > tol)).sum())} of them away from a "
        f"boundary (largest margin {margin[differ].max():.2e})")
    return int(differ.sum())
