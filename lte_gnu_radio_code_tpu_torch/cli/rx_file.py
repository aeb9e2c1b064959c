"""Recorded-IQ receiver in torch (the reference's LEGACY/gr-ofdm-rx
top_block.py: USRP source -> SynchEstAndFO -> BitRecovery -> Qt sinks,
with the radio replaced by an IQ file).

Port of ``lte_gnu_radio_code_tpu/cli/rx_file.py``: the legacy
multi-detection CFO-search receiver (``models/legacy_rx.py:rx_frame_cfo``,
or with ``--stream`` ``runtime/stream.py:LegacyStreamingRx`` in
CHUNK_LEN-sample work calls, whose detections are the same) at a case of
the hard-coded tables (``--case``; ``--dsss`` takes the DSSS table and
despreads), with the CFO candidates ``--fo-range``.  K2 demodulates on the
card.  It runs on the CUDA device unless ``--device cpu``, and raises where
there is none::

    python -m lte_gnu_radio_code_tpu_torch.cli.rx_file capture.pckl --case 7
    python -m lte_gnu_radio_code_tpu_torch.cli.rx_file capture.pckl --stream 4096
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("iq_file", help="pickle (or .npy) of complex IQ samples")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default; raises without "
                        "one) or cpu")
    p.add_argument("--case", type=int, default=7,
                   help="legacy case table index (top_block.py:129 uses 7)")
    p.add_argument("--fo-range", type=float, nargs="*", default=[0.0],
                   help="CFO candidates in Hz (top_block.py: [0])")
    p.add_argument("--dsss", type=int, default=0,
                   help="use the DSSS case table + despreading")
    p.add_argument("--max-det", type=int, default=100)
    p.add_argument("--stream", type=int, default=0, metavar="CHUNK_LEN",
                   help="run continuously in CHUNK_LEN-sample work calls "
                        "(rounded up to the search stride) instead of one "
                        "whole-buffer call; the detections are the same")
    p.add_argument("--diag-dir")
    p.add_argument("--json", action="store_true")
    return p


def load_iq(path) -> np.ndarray:
    """Samples of a .npy file or a reference-style pickle, flattened."""
    from ..io.pickles import load_pickle_iq
    if str(path).endswith(".npy"):
        return np.load(path).ravel()
    return load_pickle_iq(path).ravel()


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..models import legacy_rx
    from ..runtime.stream import LegacyStreamingRx, push_signal
    from ..utils.params import CFO_CASES, DSSS_CASES, config_from_case

    device = resolve_device(args.device)
    rx = load_iq(args.iq_file)
    table = DSSS_CASES if args.dsss else CFO_CASES
    cfg = config_from_case(table, args.case)
    dsss = table[args.case]["dsss"] if args.dsss else 1
    fo_range = tuple(args.fo_range)

    if args.stream:
        stride = max(1, cfg.stride)
        chunk = -(-args.stream // stride) * stride
        # --max-det applies in both modes: the whole-buffer receiver keeps
        # max_det slots (the legacy block's max_num_corr = 100 table)
        srx = LegacyStreamingRx(cfg, chunk, fo_range=fo_range, dsss=dsss,
                                device=device)
        _, r = push_signal(srx, rx, ("ptrs", "delays", "fo_idx", "phasors",
                                     "despread"))
        r = {k: v[:args.max_det] for k, v in r.items()}
    else:
        res = legacy_rx.make_legacy_rx(cfg, len(rx), fo_range=fo_range,
                                       dsss=dsss, max_det=args.max_det,
                                       device=device)(rx)
        n = int(res.count)
        r = {"ptrs": res.ptrs[:n], "delays": res.delays[:n],
             "fo_idx": res.fo_idx[:n], "phasors": res.phasors[:n],
             "despread": res.despread[:n]}
        r = {k: v.cpu().numpy() for k, v in r.items()}
    n = len(r["ptrs"])
    out = {"detections": n, "ptrs": r["ptrs"].tolist(),
           "delays": r["delays"].tolist(), "fo_idx": r["fo_idx"].tolist()}
    if args.diag_dir:
        from ..utils import diagnostics as diag
        diag.iq_scatter(r["despread"] if dsss > 1 else r["phasors"],
                        save_to=f"{args.diag_dir}/iq_scatter.png")
    if args.json:
        print(json.dumps(out))
    else:
        print(f"{n} detections")
        for i in range(n):
            print(f"  ptr {out['ptrs'][i]:7d}  delay {out['delays'][i]:3d}  "
                  f"fo {args.fo_range[out['fo_idx'][i]]:+.0f} Hz")
    return out


if __name__ == "__main__":
    main()
