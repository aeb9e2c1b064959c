"""The PLS key exchange (P1) in torch: Alice and Bob's three-state machine
over a 2x2 channel.

Port of ``lte_gnu_radio_code_tpu/models/pls.py`` (``make_pls``,
``mimo_channel``, ``key_exchange``, ``make_pls_synced``,
``key_exchange_synced``; pls_aio.py:107-141, topblock.py:21-95):

  alice0:  random unitary precoders -> precoded references    -> TX buffer
  bob:     estimate + SVD -> key-bit DFT precoders rotated by U_B -> TX
  alice2:  estimate + SVD -> PMI -> the recovered key bits

Every state takes leading exchange axes, so one call runs a batch of
exchanges, each with its own key bits.  The exchanges run on the CUDA
device unless asked for the CPU.  Random numbers come from an explicit
``torch.Generator``; tests inject the unitaries and the noise instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import pls as pls_ops
from ..utils.device import resolve_device
from ..utils.params import PLSConfig


def make_pls(cfg: PLSConfig, device=None):
    """(alice0, bob, alice2) on the device (``pls.py:make_pls``).
    alice0(generator, lead=()) draws unitaries [*lead, S, SB, n, n] and
    returns Alice's TX buffer [*lead, n_ant, frame_len]; bob(rx_time,
    key_bits) returns Bob's; alice2(rx_time) the recovered key bits."""
    dev = resolve_device(device)
    S, SB, n = cfg.num_data_symb, cfg.num_subbands, cfg.num_ant

    def alice0(generator: torch.Generator, lead=()):
        if generator.device != dev:
            raise ValueError(f"alice0: generator on {generator.device}, "
                             f"the exchange on {dev}")
        return pls_ops.transmit(
            cfg, pls_ops.random_unitary(generator, (*lead, S, SB), n))

    def bob(rx_time, key_bits):
        lsv_b = pls_ops.receive(cfg, rx_time)[0]
        prec = pls_ops.rotated_precoder(
            lsv_b, pls_ops.bits_to_precoders(cfg, key_bits))
        return pls_ops.transmit(cfg, prec)

    def alice2(rx_time):
        return pls_ops.receive(cfg, rx_time)[3]

    return alice0, bob, alice2


def make_pls_synced(cfg: PLSConfig, max_delay: int, device=None):
    """:func:`make_pls` with both receivers behind the timing lock
    (``pls.py:make_pls_synced``, ``ops.pls.receive_synced``): RX buffers
    hold frame_len + max_delay samples; bob returns (TX buffer, lock) and
    alice2 (bits, lock)."""
    alice0, _, _ = make_pls(cfg, device)

    def bob(rx_time, key_bits):
        lsv_b, _, _, _, ptr = pls_ops.receive_synced(cfg, rx_time, max_delay)
        prec = pls_ops.rotated_precoder(
            lsv_b, pls_ops.bits_to_precoders(cfg, key_bits))
        return pls_ops.transmit(cfg, prec), ptr

    def alice2(rx_time):
        _, _, _, bits, ptr = pls_ops.receive_synced(cfg, rx_time, max_delay)
        return bits, ptr

    return alice0, bob, alice2


def mimo_channel(cfg: PLSConfig, tx: torch.Tensor, h, snr_db=None, *,
                 generator: torch.Generator | None = None,
                 noise: torch.Tensor | None = None,
                 out_len: int | None = None) -> torch.Tensor:
    """[..., n_tx, T] through the per-pair unit-normalised CIRs h [n_rx,
    n_tx, taps] (numpy or a tensor) as one FFT product, cut to ``out_len``
    samples (default frame_len, the reference's perfect-timing loopback;
    the synced exchange keeps the delay tail), plus AWGN at ``snr_db`` over
    each exchange's mean TX power from ``generator`` or the complex
    ``noise`` [..., n_rx, out_len] (``pls.py:mimo_channel``,
    topblock.py:21-78)."""
    h = torch.as_tensor(h, device=tx.device)
    hn = (h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)).to(
        torch.complex64)
    out_len = cfg.frame_len if out_len is None else out_len
    n_out = tx.shape[-1] + h.shape[-1] - 1
    nfft = int(2 ** np.ceil(np.log2(max(n_out, out_len, 2))))
    s = torch.fft.fft(tx, nfft)
    y = torch.fft.ifft(torch.einsum("...tf,rtf->...rf", s,
                                    torch.fft.fft(hn, nfft)), nfft)
    y = y[..., :out_len].to(torch.complex64)
    if snr_db is None:
        return y
    if (generator is None) == (noise is None):
        raise ValueError("mimo_channel: with snr_db, pass exactly one of "
                         "generator= and noise=")
    if noise is None:
        noise = torch.complex(
            torch.randn(y.shape, generator=generator, device=y.device),
            torch.randn(y.shape, generator=generator, device=y.device))
    nv = (tx.abs() ** 2).mean((-2, -1)) * 10 ** (-snr_db / 10)
    return y + torch.sqrt(nv / 2.0)[..., None, None] * noise


def _run(cfg, key_bits, generator, h, snr_db, unitaries, noise, device,
         states, out_len):
    """The three states over the channel and its reciprocal (h with the
    antennas swapped); bob returns (TX buffer, lock) and alice2 (bits,
    lock).  Returns (recovered bits, bit errors, Bob's lock, Alice's)."""
    dev = resolve_device(device)
    alice0, bob, alice2 = states
    key_bits = torch.as_tensor(key_bits, device=dev)
    if unitaries is not None:
        tx_a = pls_ops.transmit(cfg, torch.as_tensor(unitaries, device=dev))
    else:
        tx_a = alice0(generator, key_bits.shape[:-1])
    n_b, n_a = (None, None) if noise is None else noise
    gen = generator if noise is None else None
    rx_b = mimo_channel(cfg, tx_a, h, snr_db, generator=gen, noise=n_b,
                        out_len=out_len)
    tx_b, ptr_b = bob(rx_b, key_bits)
    h_back = np.swapaxes(h, 0, 1) if isinstance(h, np.ndarray) else \
        h.transpose(0, 1)                               # reciprocity
    bits, ptr_a = alice2(mimo_channel(cfg, tx_b, h_back, snr_db,
                                      generator=gen, noise=n_a,
                                      out_len=out_len))
    err = (bits ^ key_bits.reshape(bits.shape)).sum(-1)
    return bits, err, ptr_b, ptr_a


def key_exchange(cfg: PLSConfig, key_bits, generator=None, h=None,
                 snr_db=None, *, unitaries=None, noise=None, device=None):
    """The whole exchange at perfect timing (``pls.py:key_exchange``):
    key_bits [..., key bits] -> (recovered bits, bit errors [...]).  h
    defaults to the all-ones 1-tap channel.  ``unitaries`` [..., S, SB, n,
    n] replaces Alice's draw, ``noise`` = (Bob's, Alice's) [..., n_ant,
    frame_len] the AWGN draws; the generator draws whatever is not given."""
    if h is None:
        h = np.ones((cfg.num_ant, cfg.num_ant, 1), dtype=np.complex128)
    alice0, bob, alice2 = make_pls(cfg, device)
    bits, err, _, _ = _run(
        cfg, key_bits, generator, h, snr_db, unitaries, noise, device,
        (alice0, lambda rx, key: (bob(rx, key), None),
         lambda rx: (alice2(rx), None)), None)
    return bits, err


def key_exchange_synced(cfg: PLSConfig, key_bits, generator, h,
                        snr_db=None, max_delay: int = 16, *, unitaries=None,
                        noise=None, device=None):
    """The exchange over a channel with propagation delay, timing
    recovered by the ZC delay search at both ends
    (``pls.py:key_exchange_synced``).  Returns (recovered bits, bit errors,
    (Bob's lock, Alice's lock)); RX buffers and ``noise`` hold frame_len +
    max_delay samples."""
    bits, err, ptr_b, ptr_a = _run(
        cfg, key_bits, generator, h, snr_db, unitaries, noise, device,
        make_pls_synced(cfg, max_delay, device), cfg.frame_len + max_delay)
    return bits, err, (ptr_b, ptr_a)
