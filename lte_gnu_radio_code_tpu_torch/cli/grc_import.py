"""Import a GNU Radio Companion flowgraph of the reference and run it on
the port.

Port of ``lte_gnu_radio_code_tpu/cli/grc_import.py``: users of the
reference bring their ``.grc`` files (the YAML ``ofdm_chain.grc`` or the
GR 3.7 XML graphs ``RxReceiver_Diag.grc``, ``RXtransmit_6.grc``);
``io/grc.py`` maps them onto the port's configurations, and ``--run``
executes them: a legacy RX graph through ``models/legacy_rx.py`` on an IQ
capture, the loopback graph through the RX on a capture or as a synthetic
loopback (``models.chain.chain_batch``).  It runs on the CUDA device
unless ``--device cpu``, and raises where there is none::

    python -m lte_gnu_radio_code_tpu_torch.cli.grc_import ofdm_chain.grc -o cfg.json
    python -m lte_gnu_radio_code_tpu_torch.cli.grc_import ofdm_chain.grc --run
    python -m lte_gnu_radio_code_tpu_torch.cli.grc_import RxReceiver_Diag.grc --run --tx-pickle capture.pckl
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..utils.device import as_samples, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("grc", help=".grc flowgraph file (GR 3.7 XML or 3.8+ YAML)")
    p.add_argument("--device", default="cuda",
                   help="torch device for --run: cuda (the default; raises "
                        "without one) or cpu")
    p.add_argument("-o", "--out-config", help="write the equivalent JSON "
                   "config (configs/*.json schema) here")
    p.add_argument("--run", action="store_true",
                   help="execute the imported graph")
    p.add_argument("--tx-pickle", help="IQ capture for graphs whose source "
                   "is a radio or an absent pickle file")
    p.add_argument("--bits-pickle", help="ground-truth bits for BER")
    p.add_argument("--json", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..io.grc import interpret_grc, load_grc

    graph = load_grc(args.grc)
    plan = interpret_grc(graph)
    out = {"format": graph.fmt, "kind": plan.kind,
           "blocks": [b.key for b in graph.enabled_blocks()],
           "source": plan.source, "rx": plan.rx, "sinks": plan.sinks,
           "notes": plan.notes, "config": plan.config_json()}
    if args.out_config and plan.config is not None:
        with open(args.out_config, "w") as f:
            json.dump(plan.config_json(), f, indent=2)
        out["config_written"] = args.out_config
    if args.run:
        out["run"] = _run(plan, args, resolve_device(args.device))
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
    return out


def _iq_input(plan, args):
    """The graph's source as an IQ buffer, where one is available."""
    from ..io.pickles import load_pickle_iq

    if args.tx_pickle:
        return load_pickle_iq(args.tx_pickle).ravel()
    src = plan.source
    if src.get("kind") in ("pickle", "chunked_pickle", "timed_pickle"):
        path = str(src.get("directory", "")) + str(src.get("file", ""))
        if path:
            try:
                return load_pickle_iq(path).ravel()
            except OSError:
                pass
    return None


def _ber(hard, bits_path) -> float:
    from ..io.pickles import load_pickle_iq
    gt = load_pickle_iq(bits_path).ravel()
    hb = np.asarray(hard).ravel()[:len(gt)]
    return float(np.mean(hb != gt[:len(hb)]))


def _run(plan, args, device):
    cfg = plan.config
    if cfg is None:
        return {"error": "no runnable RX/TX block found in the graph"}
    rx_sig = _iq_input(plan, args)

    if plan.kind == "legacy_rx":
        from ..models import legacy_rx
        from ..ops import modulation

        if rx_sig is None:
            return {"error": "legacy RX graph needs an IQ capture "
                             "(--tx-pickle); its source was a radio"}
        dsss = int(plan.rx.get("dsss", 1))
        r = legacy_rx.make_legacy_rx(
            cfg, len(rx_sig), fo_range=tuple(plan.rx.get("fo_range", [0.0])),
            dsss=dsss, device=device)(rx_sig)
        n_det = int(r.count)
        res = {"detections": n_det, "ptrs": r.ptrs[:n_det][:5].tolist()}
        if plan.rx.get("bit_recovery"):                 # BitRecovery block
            phas = (r.despread if dsss > 1 else r.phasors)[:n_det]
            demap = (modulation.qpsk_llr_pairswap
                     if plan.rx["bit_recovery"]["variant"] == "pairswap"
                     else modulation.qpsk_llr)
            hard, _, _ = demap(phas.reshape(-1))
            res["hard_bits"] = int(hard.numel())
            if args.bits_pickle:
                res["ber"] = _ber(hard.cpu().numpy(), args.bits_pickle)
        return res

    # the loopback graph: the RX on an IQ buffer if there is one, else a
    # synthetic loopback
    from ..models import chain, rxofdm

    if rx_sig is not None:
        x = as_samples(rx_sig, device)
        r = rxofdm.make_rx(cfg, x.shape[0])(x)
        res = {"mode": "rx_pickle", "found": bool(r.found),
               "lock_ptr": int(r.lock_ptr)}
        if args.bits_pickle:
            res["ber"] = _ber(r.hard_bits.cpu().numpy(), args.bits_pickle)
        return res
    bits = torch.as_tensor(np.random.default_rng(0).integers(
        0, 2, (1, cfg.num_bits), dtype=np.int32), device=device)
    n_trials, num_patterns = rxofdm.plan_rx(cfg, cfg.frame_len + cfg.nfft - 1)
    r = chain.chain_batch(cfg, chain.loopback_taps(cfg), n_trials,
                          num_patterns, bits,
                          generator=torch.Generator(device=device
                                                    ).manual_seed(0))
    return {"mode": "loopback", "found": bool(r.found[0]),
            "lock_ptr": int(r.lock_ptr[0]), "ber": float(r.ber[0])}


if __name__ == "__main__":
    main()
