"""Offline TX / RX simulation script in torch (the reference's
txrx_mod/SDRScript.py).

Port of ``lte_gnu_radio_code_tpu/cli/sdrscript.py``: for an SDR profile
and an Eb/N0 list, seeded bits, the TX frame, the TX time signal of the
first point pickled (the hand-off the GNU Radio TX blocks stream,
SDRScript.py:136-139), then the loopback chain (``models.chain.chain_batch``:
K1-K4 on the card) and the BER of each point.  It runs on the CUDA device
unless ``--device cpu``, and raises where there is none::

    python -m lte_gnu_radio_code_tpu_torch.cli.sdrscript --case 0 --ebno-db 10 100
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from ..utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default; raises without "
                        "one) or cpu")
    p.add_argument("--case", type=int, default=0, choices=[0, 1],
                   help="SDR profile (0: 4G5GSISO-TU, 1: WIFIMIMOSM-A)")
    p.add_argument("--ebno-db", type=float, nargs="*", default=None,
                   help="override the profile's Eb/N0 sweep list")
    p.add_argument("--num-symbols", type=int, default=None)
    p.add_argument("--out-dir", default=".",
                   help="where to write the TX pickle hand-off")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..io.pickles import save_pickle_iq
    from ..models import chain, rxofdm, txofdm
    from ..utils.params import SDR_PROFILES, config_from_profile

    device = resolve_device(args.device)
    profile = SDR_PROFILES[args.case]
    ebnos = args.ebno_db if args.ebno_db is not None else profile["ebno_db"]
    results = []
    for i, ebno in enumerate(ebnos):
        cfg = config_from_profile(profile, num_symbols=args.num_symbols,
                                  snr_db=float(ebno))
        bits = torch.as_tensor(np.random.default_rng(args.seed + i).integers(
            0, 2, (1, cfg.num_bits), dtype=np.int32), device=device)
        if i == 0:
            tx = txofdm.tx_frame(cfg, bits[0])
            save_pickle_iq(pathlib.Path(args.out_dir) / "4g5g_input_data.pckl",
                           tx.cpu().numpy()[None, :])
        n_trials, num_patterns = rxofdm.plan_rx(cfg,
                                                cfg.frame_len + cfg.nfft - 1)
        gen = torch.Generator(device=device).manual_seed(args.seed + i)
        out = chain.chain_batch(cfg, chain.loopback_taps(cfg), n_trials,
                                num_patterns, bits, generator=gen)
        results.append({"ebno_db": float(ebno), "ber": float(out.ber[0]),
                        "found": bool(out.found[0])})

    if args.json:
        print(json.dumps(results))
    else:
        for r in results:
            print(f"Eb/N0 {r['ebno_db']:6.1f} dB   BER {r['ber']:.6f}   "
                  f"lock={'yes' if r['found'] else 'NO'}")
    return results


if __name__ == "__main__":
    main()
