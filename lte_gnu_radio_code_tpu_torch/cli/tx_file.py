"""TX waveform app in torch (the reference's legacy USRP TX graph,
LEGACY/gr-ofdm-tx/grc/RXtransmit_6.grc: OFDMTransmitter -> uhd_usrp_sink,
with the radio replaced by an IQ file).

Port of ``lte_gnu_radio_code_tpu/cli/tx_file.py``.  Two modes:

* ``--generate``: the TX frame of an SDR profile and a seed, made on the
  device (K1 on the card), written out (the SDRScript.py:136-139 hand-off);
* default (replay): an existing TX pickle streamed through the chunked
  source (``io/pickles.py:ChunkedPickleSource``: <= ``--chunk``-sample work
  calls with leftover carry, ``--repeat`` passes a data set, rotation over
  ``--num-files`` numbered pickles, OFDMTransmitter.py:30-122) and a
  ``runtime/flowgraph.py:Flowgraph`` into the file.

It runs on the CUDA device unless ``--device cpu`` (the replay touches no
device), and raises where there is none::

    python -m lte_gnu_radio_code_tpu_torch.cli.tx_file tx.pckl --generate
    python -m lte_gnu_radio_code_tpu_torch.cli.tx_file out.npy --pickle-dir . --file-stem tx_data_
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from ..utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_file", help="output IQ file (.npy or .pckl)")
    p.add_argument("--device", default="cuda",
                   help="torch device for --generate: cuda (the default; "
                        "raises without one) or cpu")
    p.add_argument("--generate", action="store_true",
                   help="synthesise the TX frame instead of replaying")
    p.add_argument("--case", type=int, default=0, choices=[0, 1],
                   help="SDR profile for --generate")
    p.add_argument("--num-symbols", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pickle-dir", default=".",
                   help="replay: directory of numbered TX pickles")
    p.add_argument("--file-stem", default="tx_data_",
                   help="replay: stem of <stem><k>.pckl files "
                        "(OFDMTransmitter.py:44)")
    p.add_argument("--num-files", type=int, default=1)
    p.add_argument("--repeat", type=int, default=20,
                   help="num_repeat_per_data_set (OFDMTransmitter.py:41)")
    p.add_argument("--chunk", type=int, default=4095,
                   help="work-call quantum (OFDMTransmitter.py:52)")
    p.add_argument("--n-chunks", type=int, default=0,
                   help="replay: number of work calls to drive (default: "
                        "one full pass over every file x repeat)")
    p.add_argument("--json", action="store_true")
    return p


def generate(case: int, num_symbols, seed: int, device) -> np.ndarray:
    """The TX frame of SDR profile ``case`` for numpy-seeded bits."""
    import torch

    from ..models import txofdm
    from ..utils.params import SDR_PROFILES, config_from_profile

    cfg = config_from_profile(SDR_PROFILES[case], num_symbols=num_symbols)
    bits = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 2, cfg.num_bits, dtype=np.int32), device=device)
    return txofdm.tx_frame(cfg, bits).cpu().numpy()


def main(argv=None):
    args = build_parser().parse_args(argv)
    out_path = pathlib.Path(args.out_file)

    if args.generate:
        sig = generate(args.case, args.num_symbols, args.seed,
                       resolve_device(args.device))
        n_calls = 0
    else:
        from ..io.pickles import ChunkedPickleSource, load_pickle_iq
        from ..runtime.flowgraph import CollectSink, Flowgraph

        src = ChunkedPickleSource(args.pickle_dir, args.file_stem,
                                  num_files=args.num_files,
                                  num_repeat=args.repeat,
                                  max_chunk=args.chunk)
        if args.n_chunks:
            n_calls = args.n_chunks
        else:
            # one full pass: every file's own length x repeat (numbered
            # pickles may differ in length)
            total = sum(
                np.atleast_2d(load_pickle_iq(
                    pathlib.Path(args.pickle_dir)
                    / f"{args.file_stem}{k}.pckl"))[0].size
                for k in range(args.num_files)) * args.repeat
            n_calls = -(-total // args.chunk)
        sink = CollectSink()
        Flowgraph(args.chunk).connect(src, sink).run(n_calls)
        sig = np.concatenate(sink.items)

    if out_path.suffix == ".npy":
        np.save(out_path, sig.astype(np.complex64))
    else:
        from ..io.pickles import save_pickle_iq
        save_pickle_iq(out_path, sig[None, :])

    out = {"samples": int(sig.size), "file": str(out_path),
           "work_calls": int(n_calls),
           "mode": "generate" if args.generate else "replay"}
    print(json.dumps(out) if args.json else
          f"wrote {out['samples']} samples to {out['file']} "
          f"({out['mode']}, {out['work_calls']} work calls)")
    return out


if __name__ == "__main__":
    main()
