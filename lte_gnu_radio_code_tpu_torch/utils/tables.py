"""Constant tables: from numpy to the port's device tensors.

The system has no learned weights; what it carries are constant tables
(DFT/IDFT bases, correlation kernels, the channel impulse responses, the
QAM constellations, the pilot values and interpolators, the CFO mixer bank
and the DSSS code).  Each is built in
numpy by the port module that uses it, beside the module that builds it in
the JAX package.
:func:`port_tables` names them all for one configuration,
:func:`tables_to_device` turns such a dict (the port's, or one made by the
JAX package's table functions, whose planar tables are ``(re, im)``
pairs) into tensors, and :func:`device_table` caches one table per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .params import OFDMConfig, used_bins


def _as_array(v) -> np.ndarray:
    if isinstance(v, tuple):                    # planar (re, im) pair
        re, im = (np.asarray(p, np.float32) for p in v)
        return (re + 1j * im).astype(np.complex64)
    a = np.asarray(v)
    if a.dtype not in (np.complex64, np.float32, np.int64, np.int32):
        raise TypeError(f"table of dtype {a.dtype}: expected complex64, "
                        "float32, int64, int32 or an (re, im) float32 pair")
    return a


def tables_to_device(tables: dict, device) -> dict[str, torch.Tensor]:
    """{name: numpy table or (re, im) pair} -> {name: tensor on device}."""
    return {name: torch.from_numpy(np.ascontiguousarray(_as_array(v))
                                   ).to(device)
            for name, v in tables.items()}


@functools.lru_cache(maxsize=None)
def device_table(make, device: torch.device, *args) -> torch.Tensor:
    """make(*args) as a tensor on ``device``, made once per device."""
    return tables_to_device({"t": make(*args)}, device)["t"]


def port_tables(cfg: OFDMConfig, fo_range=None,
                dsss: int = 1) -> dict[str, np.ndarray]:
    """Every constant table the ported receivers use at ``cfg``: the
    loopback chain's, the constellation of every modulation, with a pilot
    grid the pilot values and both interpolators, and for the legacy
    receivers (``fo_range`` given) the CFO mixer bank and the DSSS code."""
    from ..kernels import equalize, ofdm_mod
    from ..ops import cfo, channel, fast_sync, modulation, pilots, sync

    _, data_bins = used_bins(cfg.nfft, cfg.num_data_bins)
    out = {
        "sync_kernels": fast_sync._kernels(cfg),
        "idft": ofdm_mod._idft_mats(cfg.nfft),
        "idft_data_bins": ofdm_mod._idft_bin_mats(cfg.nfft, data_bins),
        "dft_data_bins": equalize._dft_bins_mats(cfg.nfft, cfg.num_data_bins),
        "dft_synch_bins": sync._dft_synch_bins(cfg.nfft, cfg.num_synch_bins),
    }
    for name in channel.CHANNELS_SISO:
        out[f"cir_{name}"] = channel.channel_taps(name)
    for mod in modulation.BITS_PER_SYMBOL:
        pts, bit_tbl = modulation._constellation_table(mod)
        out[f"points_{mod}"], out[f"point_bits_{mod}"] = pts, bit_tbl
    if cfg.pilot_grid != "none":
        left, weight = pilots._linear_interp_plan(cfg)
        out.update(pilot_values=pilots.pilot_values(cfg),
                   pilot_interp_cir=pilots._cir_interp_matrix(cfg),
                   pilot_interp_left=left, pilot_interp_weight=weight)
    if fo_range is not None:
        out["cfo_bank"] = cfo.cfo_bank(cfg, fo_range)
        out["dsss_code"] = cfo.dsss_code(dsss)
    return out
