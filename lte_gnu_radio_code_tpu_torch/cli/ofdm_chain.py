"""The loopback app in torch (the reference's ofdm_chain.py: TXOFDM pickle
source -> RXOFDM synch_and_chan_est -> null sink), for any modulation and
pilot grid.

Port of ``lte_gnu_radio_code_tpu/cli/ofdm_chain.py``.  Modes:

* default: bits -> TX -> channel -> AWGN -> RX -> bits through the port's
  main path (``models.chain.chain_batch``: the four kernels on a CUDA
  device, their plain twins on the CPU);
* ``--tx-pickle``: a recorded or pickled IQ buffer through the RX
  (``models.rxofdm.make_rx``: K4 and K2 on the card), BER against
  ``--bits-pickle``;
* ``--stream CHUNK_LEN``: the continuous multi-detection receiver
  (``runtime.stream.ReacqStreamingRx``) in chunks of that many samples over
  the pickle, or over one synthetic frame (the port's TX and channel),
  replayed ``--repeat`` times;
* ``--diag-dir``: channel-estimate dump and IQ scatter there.

It runs on the CUDA device unless asked for the CPU, and raises where there
is no CUDA device instead of moving to the CPU on its own::

    python -m lte_gnu_radio_code_tpu_torch.cli.ofdm_chain
    python -m lte_gnu_radio_code_tpu_torch.cli.ofdm_chain --device cpu
    python -m lte_gnu_radio_code_tpu_torch.cli.ofdm_chain --config configs/tx16qam.json
    python -m lte_gnu_radio_code_tpu_torch.cli.ofdm_chain --tx-pickle rx.pckl --bits-pickle bits.pckl
    python -m lte_gnu_radio_code_tpu_torch.cli.ofdm_chain --stream 960 --repeat 3
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..utils.device import as_samples, resolve_device


def build_config(args):
    from ..utils.params import OFDMConfig
    from .ber_sweep import load_config
    kw = dict(
        nfft=args.nfft, cp_len=args.cp_len, num_ofdm_symb=args.num_ofdm_symb,
        synch_dat=tuple(args.synch_dat), num_data_bins=args.num_data_bins,
        num_synch_bins=args.nfft - 2, snr_db=args.snr,
        detection_gate=args.gate, channel=args.channel,
        modulation=args.modulation, pilot_grid=args.pilot_grid,
        pilot_spacing=args.pilot_spacing, ref_sigs=args.ref_sigs,
        stride=args.stride)
    if args.config:
        kw.update(load_config(args.config))
    return OFDMConfig(**kw).validate()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default; raises without "
                        "one) or cpu")
    p.add_argument("--nfft", type=int, default=64)
    p.add_argument("--cp-len", type=int, default=16)
    p.add_argument("--num-ofdm-symb", type=int, default=240)
    p.add_argument("--synch-dat", type=int, nargs=2, default=[1, 3])
    p.add_argument("--num-data-bins", type=int, default=60)
    p.add_argument("--snr", type=float, default=100.0)
    p.add_argument("--gate", type=float, default=0.7)
    p.add_argument("--stride", type=int, default=1,
                   help="sync trial stride (1 dense; cp_len-1 at LTE scale)")
    p.add_argument("--channel", default="Fading",
                   choices=["Ideal", "IMT1", "IMT16", "Fading", "AWGN"])
    p.add_argument("--modulation", default="QPSK",
                   choices=["BPSK", "QPSK", "QAM16", "QAM64"])
    p.add_argument("--pilot-grid", default="none",
                   choices=["none", "lte", "random"],
                   help="scattered-pilot grid + pilot channel estimate "
                        "(ops/pilots)")
    p.add_argument("--pilot-spacing", type=int, default=4)
    p.add_argument("--ref-sigs", type=float, default=0.0,
                   help="pilot bin fraction for --pilot-grid random")
    p.add_argument("--config", help="JSON config file (configs/*.json); its "
                                    "fields override the flags above")
    p.add_argument("--tx-pickle", help="stream this IQ pickle through the RX")
    p.add_argument("--bits-pickle", help="ground-truth bits for BER")
    p.add_argument("--stream", type=int, default=0, metavar="CHUNK_LEN",
                   help="run the continuous multi-detection receiver "
                        "(channel refreshed per detection) in chunks of "
                        "this many samples instead of one batch call")
    p.add_argument("--repeat", type=int, default=1,
                   help="with --stream: replay the input this many times")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--diag-dir", help="write channel-est dump and IQ scatter "
                                      "here")
    p.add_argument("--json", action="store_true", help="machine-readable out")
    return p


def _ber(hard: np.ndarray, bits_path: str, repeat: int = 1) -> float:
    from ..io.pickles import load_pickle_iq
    gt = np.tile(load_pickle_iq(bits_path).ravel(), repeat)
    h = np.asarray(hard).ravel()[:len(gt)]
    return float(np.mean(h != gt[:len(h)]))


def synthetic_frame(cfg, seed: int, device) -> torch.Tensor:
    """One frame of seeded bits through the port's TX and the config's
    channel (no noise), with the channel's nfft - 1 sample tail."""
    from ..models import chain, txofdm
    from ..ops import channel as chan_ops

    bits = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 2, cfg.num_bits, dtype=np.int32), device=device)
    tx = txofdm.tx_frame(cfg, bits)
    return chan_ops.apply_channel(tx, chain.loopback_taps(cfg),
                                  max_impulse=cfg.nfft)


def _print(out: dict, as_json: bool) -> None:
    if as_json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..io.pickles import load_pickle_iq
    from ..models import chain, rxofdm
    from ..runtime.stream import ReacqStreamingRx, push_signal
    from ..utils import diagnostics as diag

    cfg = build_config(args)
    device = resolve_device(args.device)

    if args.stream:
        if args.tx_pickle:
            sig = load_pickle_iq(args.tx_pickle).ravel()
        else:
            sig = synthetic_frame(cfg, args.seed, device).cpu().numpy()
        sig = np.tile(np.asarray(sig, np.complex64), args.repeat)
        steps, r = push_signal(
            ReacqStreamingRx(cfg, args.stream, device=device), sig,
            ("ptrs", "hard_bits"))
        out = {"mode": "stream", "chunk_len": args.stream,
               "chunks": steps, "detections": int(len(r["ptrs"])),
               "first_ptrs": r["ptrs"][:5].tolist()}
        if args.bits_pickle:
            out["ber"] = _ber(r["hard_bits"], args.bits_pickle, args.repeat)
        _print(out, args.json)
        return out

    if args.tx_pickle:
        rx = as_samples(load_pickle_iq(args.tx_pickle).ravel(), device)
        result = rxofdm.make_rx(cfg, rx.shape[0])(rx)
        out = {"found": bool(result.found), "lock_ptr": int(result.lock_ptr),
               "delay_idx": int(result.delay_idx)}
        if args.bits_pickle:
            out["ber"] = _ber(result.hard_bits.cpu().numpy(),
                              args.bits_pickle)
        phasors = result.phasors
    else:
        bits = torch.as_tensor(np.random.default_rng(args.seed).integers(
            0, 2, (1, cfg.num_bits), dtype=np.int32), device=device)
        n_trials, num_patterns = rxofdm.plan_rx(cfg,
                                                cfg.frame_len + cfg.nfft - 1)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        r = chain.chain_batch(cfg, chain.loopback_taps(cfg), n_trials,
                              num_patterns, bits, generator=gen)
        out = {"found": bool(r.found[0]), "lock_ptr": int(r.lock_ptr[0]),
               "delay_idx": int(r.delay_idx[0]), "ber": float(r.ber[0])}
        phasors, result = r.phasors[0], None

    if args.diag_dir:
        if result is not None:
            diag.dump_channel_estimate(args.diag_dir, "chan_est_",
                                       result.chan_est_time)
        diag.iq_scatter(phasors, save_to=f"{args.diag_dir}/iq_scatter.png")
    _print(out, args.json)
    return out


if __name__ == "__main__":
    main()
