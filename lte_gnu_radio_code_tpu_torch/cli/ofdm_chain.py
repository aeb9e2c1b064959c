"""The loopback app in torch: bits -> TX -> channel -> AWGN -> RX -> bits
through the port's main path (``models.chain.chain_batch``: the four kernels
on a CUDA device, their plain twins on the CPU), for any modulation and
pilot grid.

Port of ``lte_gnu_radio_code_tpu/cli/ofdm_chain.py``, loopback mode only
(the pickle and streaming modes are not ported yet).  It runs on the CUDA
device unless asked for the CPU, and raises where there is no CUDA device
instead of moving to the CPU on its own::

    python -m lte_gnu_radio_code_tpu_torch.cli.ofdm_chain
    python -m lte_gnu_radio_code_tpu_torch.cli.ofdm_chain --device cpu
    python -m lte_gnu_radio_code_tpu_torch.cli.ofdm_chain --config configs/tx16qam.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..utils.device import resolve_device


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
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true", help="machine-readable out")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..models import chain, rxofdm

    cfg = build_config(args)
    device = resolve_device(args.device)
    bits = torch.as_tensor(np.random.default_rng(args.seed).integers(
        0, 2, (1, cfg.num_bits), dtype=np.int32), device=device)
    n_trials, num_patterns = rxofdm.plan_rx(cfg, cfg.frame_len + cfg.nfft - 1)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    r = chain.chain_batch(cfg, chain.loopback_taps(cfg), n_trials,
                          num_patterns, bits, generator=gen)
    out = {"found": bool(r.found[0]), "lock_ptr": int(r.lock_ptr[0]),
           "delay_idx": int(r.delay_idx[0]), "ber": float(r.ber[0])}
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
    return out


if __name__ == "__main__":
    main()
