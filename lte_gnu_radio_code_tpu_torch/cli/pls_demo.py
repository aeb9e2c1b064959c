"""PLS key-exchange demo (the reference topblock.py's pls=True path): drives
the three-state Alice/Bob machine through a 2x2 channel and reports key-bit
errors.  Port of ``lte_gnu_radio_code_tpu/cli/pls_demo.py`` with the same
flags plus ``--device``: it runs on the CUDA device unless ``--device
cpu``.

    python -m lte_gnu_radio_code_tpu_torch.cli.pls_demo --device cpu --iters 3
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--key-bits", type=int, default=8,
                   help="pvt_info_length (topblock.py:83)")
    p.add_argument("--channel", default="ones",
                   choices=["ones", "symmetric", "dispersive"])
    p.add_argument("--snr", type=float, default=None,
                   help="add AWGN at this SNR (dB); default noise-free")
    p.add_argument("--iters", type=int, default=5,
                   help="exchange repetitions (topblock.py:87)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    from ..models import pls as M
    from ..utils.device import resolve_device
    from ..utils.params import PLSConfig

    device = resolve_device(args.device)
    cfg = PLSConfig(pvt_info_len=args.key_bits)
    rng = np.random.default_rng(args.seed)
    if args.channel == "ones":
        h = None
    else:
        taps = 1 if args.channel == "symmetric" else 3
        h = (rng.standard_normal((2, 2, taps)) +
             1j * rng.standard_normal((2, 2, taps)))
        h[1, 0] = h[0, 1]

    results = []
    for it in range(args.iters):
        key_bits = rng.integers(0, 2, cfg.pvt_info_len, dtype=np.int32)
        gen = torch.Generator(device=device).manual_seed(args.seed + it)
        bits, err = M.key_exchange(cfg, key_bits, gen, h=h,
                                   snr_db=args.snr, device=device)
        recovered = bits.cpu().numpy().tolist()
        results.append({"iter": it, "bit_errors": int(err),
                        "key": key_bits.tolist(), "recovered": recovered})
        if not args.json:
            print(f"iter {it}: {int(err)} bit errors "
                  f"(key {key_bits.tolist()} -> {recovered})")
    if args.json:
        print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
