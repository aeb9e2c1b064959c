"""GRC flowgraph importer: load the reference's GNU Radio Companion graphs
and map them onto the port's configurations and pipelines.

Copy of ``lte_gnu_radio_code_tpu/io/grc.py`` (``load_grc``,
``interpret_grc`` and their data classes), pure Python, over the port's
``utils/params.py``.  The reference ships four ``.grc`` flowgraphs:

* ``GNU-Radio-Repositories/ofdm_chain.grc`` (and a copy under
  ``gr-RXOFDM/``), GR 3.8+ YAML: TXOFDM pickle source -> RXOFDM
  synch_and_chan_est -> null sink (the loopback).
* ``LEGACY/gr-ofdm-rx/examples/RxReceiver_Diag.grc``, GR 3.7 XML:
  uhd_usrp_source -> SynchEstAndFO(case 7, fo_range [0]) -> BitRecovery +
  qtgui sinks (the diagnostic RX app).
* ``LEGACY/gr-ofdm-tx/grc/RXtransmit_6.grc``, GR 3.7 XML: OFDMTxWithTimer
  (case 9) -> uhd_usrp_sink (the TX graph; several disabled variants).

``load_grc`` parses either format into a neutral graph; ``interpret_grc``
maps the known reference blocks onto an :class:`OFDMConfig` for the RX / TX
numerology, a source spec (pickle file / case table) and notes recording
every substitution (UHD radios -> file-backed IQ, Qt/WX GUI sinks ->
diagnostics artifacts).  Each block generation's constructor conventions
are kept as its Python implements them:

* ``RXOFDM_synch_and_chan_est``: ZC prime 37, detection gate 0.4, search
  stride cp_len - 1, and the ``snr`` value used raw as the linear MMSE
  regulariser (gr-RXOFDM/python/synch_and_chan_est.py:53,81,102,170).
* ``utsa_ofdm_SynchAndChanEst``: prime 23, parameterised
  ``scale_factor_gate``, stride 1, SNR in dB via 10^(snr/20)
  (gr-utsa_ofdm/python/SynchAndChanEst.py:52,77,99,166).
* ``OFDMReceiver_SynchEstAndFO`` / ``_SynchEstFOAndDSSS``: everything from
  the hard-coded case tables (SynchEstAndFO.py:36-137).
"""

from __future__ import annotations

import ast
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class GrcBlock:
    name: str                 # instance id, e.g. RXOFDM_synch_and_chan_est_0
    key: str                  # block type id, e.g. RXOFDM_synch_and_chan_est
    params: Dict[str, str]
    enabled: bool = True


@dataclass
class GrcGraph:
    path: str
    fmt: str                  # "yaml" (GR 3.8+) | "xml" (GR 3.7)
    blocks: List[GrcBlock]
    connections: List[Tuple[str, str, str, str]]

    def block(self, name: str) -> GrcBlock:
        for b in self.blocks:
            if b.name == name:
                return b
        raise KeyError(name)

    def enabled_blocks(self) -> List[GrcBlock]:
        return [b for b in self.blocks if b.enabled]


def _is_enabled(value) -> bool:
    # 'bypassed' blocks are excluded from execution by GRC just like
    # disabled ones (a bypassed DSP block must not be interpreted as
    # running), so both states map to disabled here.
    return str(value).strip().lower() not in (
        "0", "false", "disabled", "bypassed", "")


def load_grc(path: str) -> GrcGraph:
    """Parse a .grc file in either the GR 3.7 XML or GR 3.8+ YAML format."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    if text.lstrip().startswith("<?xml"):
        return _load_grc_xml(path, text)
    return _load_grc_yaml(path, text)


def _load_grc_yaml(path: str, text: str) -> GrcGraph:
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "GR 3.8+ .grc files are YAML; install pyyaml to import them. "
            "GR 3.7 XML graphs need no extra.") from e

    doc = yaml.safe_load(text)
    blocks = []
    for b in doc.get("blocks") or []:
        params = {k: ("" if v is None else str(v).strip())
                  for k, v in (b.get("parameters") or {}).items()}
        state = (b.get("states") or {}).get("state", "enabled")
        blocks.append(GrcBlock(name=str(b.get("name")), key=str(b.get("id")),
                               params=params,
                               enabled=_is_enabled(state) or state is True))
    conns = [tuple(str(x) for x in c) for c in doc.get("connections") or []]
    return GrcGraph(path=path, fmt="yaml", blocks=blocks, connections=conns)


def _load_grc_xml(path: str, text: str) -> GrcGraph:
    root = ET.fromstring(text)
    blocks = []
    for b in root.findall("block"):
        key = b.find("key").text or ""
        params = {}
        for p in b.findall("param"):
            params[p.find("key").text] = (p.find("value").text or "").strip()
        if key in ("options",):
            continue
        blocks.append(GrcBlock(name=params.get("id", key), key=key,
                               params=params,
                               enabled=_is_enabled(
                                   params.get("_enabled", "True"))))
    conns = []
    for c in root.findall("connection"):
        conns.append(tuple((c.find(x).text or "")
                     for x in ("source_block_id", "source_key",
                               "sink_block_id", "sink_key")))
    return GrcGraph(path=path, fmt="xml", blocks=blocks, connections=conns)


# Parameter evaluation --------------------------------------------------------

def _variables(graph: GrcGraph) -> Dict[str, object]:
    """Collect the graph's `variable` blocks (e.g. samp_rate, fft_size)."""
    env: Dict[str, object] = {}
    for b in graph.blocks:
        if b.key == "variable":
            try:
                env[b.name] = _eval(b.params.get("value", ""), env)
            except ValueError:
                env[b.name] = b.params.get("value", "")
    return env


_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _eval(expr: str, env: Optional[Dict[str, object]] = None):
    """Evaluate a GRC parameter expression to a Python value.

    Handles the forms the reference graphs actually use: int/float/str
    literals, quoted strings, lists, `list([0])`, variable references, and
    simple arithmetic on variables (e.g. `fft1/4`). Raises ValueError for
    anything unresolvable.
    """
    env = env or {}
    s = expr.strip()
    if not s:
        return ""
    if _NAME.match(s) and s in env:
        return env[s]
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        pass
    # list(...) wrapper (RxReceiver_Diag.grc fo_range = 'list([0])')
    m = re.match(r"^list\((.*)\)$", s)
    if m:
        return list(_eval(m.group(1), env))
    # restricted arithmetic over variables: names + numbers + operators.
    # `**` is allowed only with a small literal integer exponent (the GRC
    # idiom `2**10`), never nested (`9**9**9` would hang the import); and
    # every operand — constant OR variable value — must be numeric, so
    # `'a'*10**9`-style memory bombs can't reach eval through either path.
    _ops = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod)
    _unary = (ast.USub, ast.UAdd)

    def _pow_ok(n):
        return (not isinstance(n.op, ast.Pow) or
                (isinstance(n.right, ast.Constant) and
                 isinstance(n.right.value, int) and
                 abs(n.right.value) <= 64))

    tree_ok = False
    try:
        tree = ast.parse(s, mode="eval")
        tree_ok = all(
            isinstance(n, (ast.Expression, ast.BinOp, ast.UnaryOp,
                           ast.Constant, ast.Name, ast.List, ast.Tuple,
                           ast.Load, ast.Pow) + _ops + _unary)
            for n in ast.walk(tree)) and all(
            isinstance(n.value, (int, float, complex))
            for n in ast.walk(tree) if isinstance(n, ast.Constant)) and all(
            _pow_ok(n) for n in ast.walk(tree) if isinstance(n, ast.BinOp))
    except SyntaxError:
        pass
    if tree_ok:
        names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        numeric = (int, float, complex)
        if names <= {k for k, v in env.items()
                     if isinstance(v, numeric) or
                     (isinstance(v, (list, tuple)) and
                      all(isinstance(e, numeric) for e in v))}:
            return eval(compile(tree, "<grc>", "eval"), {"__builtins__": {}},
                        dict(env))
    raise ValueError(f"unresolvable GRC expression: {expr!r}")


# Interpretation --------------------------------------------------------------

@dataclass
class GrcPlan:
    """What this framework will run for an imported flowgraph."""
    kind: str                       # flagship_loopback | legacy_rx | legacy_tx
    config: Optional[object] = None  # OFDMConfig for the RX/TX numerology
    source: Dict[str, object] = field(default_factory=dict)
    rx: Dict[str, object] = field(default_factory=dict)
    sinks: List[str] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)

    def config_json(self) -> Dict[str, object]:
        """The configs/*.json schema dict for the imported numerology."""
        c = self.config
        if c is None:
            return {}
        return {
            "nfft": c.nfft, "cp_len": c.cp_len,
            "num_ofdm_symb": c.num_ofdm_symb,
            "synch_dat": list(c.synch_dat),
            "num_data_bins": c.num_data_bins,
            "num_synch_bins": c.num_synch_bins,
            "modulation": c.modulation, "snr_db": c.snr_db,
            "channel": c.channel,
        }


_GUI_SINKS = ("qtgui_", "wxgui_", "blocks_null_sink")


def interpret_grc(graph: GrcGraph) -> GrcPlan:
    """Map a parsed reference flowgraph onto this framework."""
    from ..utils.params import (CFO_CASES, DSSS_CASES, OFDMConfig,
                                config_from_case)

    env = _variables(graph)
    plan = GrcPlan(kind="unknown")
    enabled = graph.enabled_blocks()

    def param(b, key, default=None):
        if key not in b.params:
            return default
        try:
            return _eval(b.params[key], env)
        except ValueError:
            return b.params[key]

    for b in enabled:
        k = b.key
        if k in ("RXOFDM_synch_and_chan_est", "utsa_ofdm_SynchAndChanEst"):
            utsa = k.startswith("utsa")
            nfft = int(param(b, "nfft", 64))
            nsb = int(param(b, "num_synch_bins", nfft - 2))
            if nsb > nfft - 2:
                # ofdm_chain.grc passes 64 with NFFT 64; the blocks only ever
                # use NFFT-2 bins (SystemModel.py:36) — adjudicated clamp.
                plan.notes.append(
                    f"num_synch_bins {nsb} > NFFT-2: clamped to {nfft - 2} "
                    "(SystemModel.py:36)")
                nsb = nfft - 2
            cp = int(param(b, "cp_len", 16))
            plan.kind = "flagship_loopback"
            plan.config = OFDMConfig(
                nfft=nfft, cp_len=cp,
                num_ofdm_symb=int(param(b, "num_ofdm_symb", 24)),
                synch_dat=tuple(param(b, "synch_dat", [1, 3])),
                num_data_bins=int(param(b, "num_data_bins", 60)),
                num_synch_bins=nsb,
                snr_db=float(param(b, "snr", 50)),
                zc_prime=23 if utsa else 37,
                zc_parity_on="mm" if utsa else "bins",
                snr_convention="db20" if utsa else "linear",
                detection_gate=(float(param(b, "scale_factor_gate", 0.7))
                                if utsa else 0.4),
                stride=1 if utsa else max(1, cp - 1),
                channel=str(param(b, "channel", "Fading")) or "Fading",
            )
            plan.rx.update(family="utsa" if utsa else "rxofdm",
                           genie=bool(param(b, "genie", 0)),
                           diagnostics=bool(param(b, "diagnostics", 0)))
        elif k in ("OFDMReceiver_SynchEstAndFO",
                   "OFDMReceiver_SynchEstFOAndDSSS"):
            dsss = k.endswith("DSSS")
            case = int(param(b, "case", 0))
            table = DSSS_CASES if dsss else CFO_CASES
            plan.kind = "legacy_rx"
            plan.config = config_from_case(table, case)
            plan.rx.update(family="legacy", case=case,
                           dsss=(table[case]["dsss"] if dsss else 1),
                           fo_range=list(param(b, "fo_range", [0.0])),
                           diagnostics=bool(param(b, "diagnostics", 0)))
        elif k in ("OFDMReceiver_BitRecovery", "OFDMReceiver_Bit_Recovery",
                   "OFDMReceiver_bit_recovery_c"):
            plan.rx["bit_recovery"] = {
                "modulation": str(param(b, "modulation", "QPSK")),
                # Bit_Recovery.py:143-147 swaps bit pairs per stream
                "variant": ("pairswap" if "Bit_Recovery" in k
                            or "bit_recovery_c" in k else "reference"),
            }
        elif k in ("TXOFDM_tx_signal_transmitter",
                   "utsa_ofdm_TxSignalTransmitter"):
            plan.source = {"kind": "pickle",
                           "case": int(param(b, "case", 0)),
                           "directory": str(param(b, "pickle_directory", "")),
                           "file": str(param(b, "pickle_file", ""))}
        elif k == "OFDMTransmitter_OFDMTransmitter":
            plan.kind = plan.kind if plan.kind != "unknown" else "legacy_tx"
            plan.source = {"kind": "chunked_pickle",
                           "case": int(param(b, "case", 0)),
                           "nfft": int(param(b, "fft_size", 64)),
                           "num_data_bins": int(param(b, "num_data_bins", 60)),
                           "num_ofdm_symb": int(param(b, "num_ofdm_symb", 24))}
        elif k == "OFDMTransmitter_OFDMTxWithTimer":
            plan.kind = plan.kind if plan.kind != "unknown" else "legacy_tx"
            plan.source = {"kind": "timed_pickle",
                           "case": int(param(b, "case", 0))}
        elif k == "OFDMTransmitter_SimpleTx":
            plan.kind = plan.kind if plan.kind != "unknown" else "legacy_tx"
            plan.source = {"kind": "pickle"}
        elif k == "uhd_usrp_source":
            plan.source = {"kind": "iq_file",
                           "samp_rate": param(b, "samp_rate", None)}
            plan.notes.append(
                "uhd_usrp_source replaced by a file-backed IQ source "
                "(radio I/O is out of scope); pass --tx-pickle/iq_file "
                "with a recorded capture")
        elif k == "uhd_usrp_sink":
            plan.sinks.append("iq_file")
            plan.notes.append(
                "uhd_usrp_sink replaced by a file-backed IQ sink")
        elif k.startswith(_GUI_SINKS):
            plan.sinks.append(k)
            if k.startswith(("qtgui_", "wxgui_")):
                plan.notes.append(
                    f"{k} replaced by diagnostics artifacts "
                    "(utils/diagnostics.py: IQ scatter, time/PSD dumps)")
        elif k in ("variable", "options", "note"):
            pass
        else:
            plan.notes.append(f"unrecognised block {k!r} ignored")

    if plan.config is not None:
        plan.config = plan.config.validate()
    return plan
