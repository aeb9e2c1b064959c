"""BER against SNR through the port's loopback chain: TX -> multipath
channel -> AWGN -> RX with the one-tap MMSE equaliser, any modulation and
pilot grid (``models.chain.chain_batch``: the four kernels on a CUDA device,
their plain twins on the CPU).

Port of ``lte_gnu_radio_code_tpu/cli/ber_sweep.py``.  ``--check-oracle``
also runs the numpy oracle (``reference_cpu/golden.py:run_chain``) on the
same seeds at each point, for BPSK and QPSK.  It runs on the CUDA device
unless asked for the CPU, and raises where there is no CUDA device::

    python -m lte_gnu_radio_code_tpu_torch.cli.ber_sweep --config configs/qam64_sweep.json
    python -m lte_gnu_radio_code_tpu_torch.cli.ber_sweep --modulation QAM16 --device cpu
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..utils.device import resolve_device


def load_config(path: str) -> dict:
    """OFDMConfig keyword arguments from a ``configs/*.json`` file."""
    with open(path) as f:
        base = json.load(f)
    if "synch_dat" in base:
        base["synch_dat"] = tuple(base["synch_dat"])
    return base


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default; raises without "
                        "one) or cpu")
    p.add_argument("--snrs", type=float, nargs="*",
                   default=[6, 8, 10, 12, 14, 16, 20, 24])
    p.add_argument("--config", help="JSON config file (e.g. "
                                    "configs/qam64_sweep.json); its "
                                    "modulation/channel/shape override the "
                                    "flags below")
    p.add_argument("--modulation", default="QPSK",
                   choices=["BPSK", "QPSK", "QAM16", "QAM64"])
    p.add_argument("--channel", default="Fading")
    p.add_argument("--num-ofdm-symb", type=int, default=240)
    p.add_argument("--frames", type=int, default=4, help="frames per point")
    p.add_argument("--check-oracle", action="store_true",
                   help="also run the CPU reference oracle per point")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..models import chain, rxofdm
    from ..utils.params import OFDMConfig

    device = resolve_device(args.device)
    base = load_config(args.config) if args.config else {}
    results = []
    for snr in args.snrs:
        kw = dict(modulation=args.modulation, channel=args.channel,
                  num_ofdm_symb=args.num_ofdm_symb)
        kw.update(base)
        kw["snr_db"] = float(snr)
        cfg = OFDMConfig(**kw).validate()
        n_trials, num_patterns = rxofdm.plan_rx(
            cfg, cfg.frame_len + cfg.nfft - 1)
        seeds = [1000 * args.seed + s for s in range(args.frames)]
        # the frames of one point as one batch, each frame's bits from its
        # own numpy seed
        bits = torch.as_tensor(np.stack([
            np.random.default_rng(s).integers(0, 2, cfg.num_bits,
                                              dtype=np.int32)
            for s in seeds]), device=device)
        gen = torch.Generator(device=device).manual_seed(seeds[0])
        r = chain.chain_batch(cfg, chain.loopback_taps(cfg), n_trials,
                              num_patterns, bits, generator=gen)
        row = {"snr_db": float(snr), "ber": float(r.ber.mean())}
        if args.check_oracle and cfg.modulation in ("BPSK", "QPSK"):
            from ..reference_cpu import golden
            row["oracle_ber"] = float(np.mean(
                [golden.run_chain(cfg, seed=s)["ber"] for s in seeds]))
        results.append(row)
        if not args.json:
            line = f"SNR {row['snr_db']:6.1f} dB   BER {row['ber']:.6f}"
            if "oracle_ber" in row:
                line += f"   oracle {row['oracle_ber']:.6f}"
            print(line)
    if args.json:
        print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
