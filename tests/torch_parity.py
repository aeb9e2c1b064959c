"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: configuration conversion and seeded inputs."""

import dataclasses

import numpy as np

from lte_gnu_radio_code_tpu.reference_cpu import golden as G
from lte_gnu_radio_code_tpu_torch.utils import params as tparams


def port_cfg(cfg):
    """The port's OFDMConfig with the same fields as a JAX-package one."""
    return tparams.OFDMConfig(**dataclasses.asdict(cfg))


def reduced(cfg, **changes):
    return dataclasses.replace(cfg, **changes).validate()


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

