"""The PyTorch port's configuration and constant tables against the JAX
package's table functions, and the rule that the port imports no JAX."""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from lte_gnu_radio_code_tpu.ops import cfo as jcfo
from lte_gnu_radio_code_tpu.ops import channel as jchan
from lte_gnu_radio_code_tpu.ops import fast_sync as jfs
from lte_gnu_radio_code_tpu.ops import modulation as jmodulation
from lte_gnu_radio_code_tpu.ops import pilots as jpilots
from lte_gnu_radio_code_tpu.ops import sync as jsync
from lte_gnu_radio_code_tpu.ops import zadoff_chu as jzc
from lte_gnu_radio_code_tpu.pallas_kernels import equalize as jeq
from lte_gnu_radio_code_tpu.pallas_kernels import ofdm_mod as jmod
from lte_gnu_radio_code_tpu.utils import params as jparams
from lte_gnu_radio_code_tpu_torch.ops import zadoff_chu as tzc
from lte_gnu_radio_code_tpu_torch.utils import params as tparams
from lte_gnu_radio_code_tpu_torch.utils.tables import (port_tables,
                                                       tables_to_device)
from torch_parity import port_cfg

CONFIGS = ["GOLDEN64", "LTE1024", "LTE2048"]
DERIVED = ["rx_b_len", "m_synch", "n_data_per_pattern", "pattern_len", "mm",
           "num_patterns", "num_data_symb", "bits_per_bin",
           "num_data_only_bins", "num_bits", "frame_len", "snr_linear", "fs"]


def jax_tables(cfg, fo_range=None, dsss=1):
    """The same tables as port_tables, from the JAX package's functions
    (its linear interpolator is ``jnp.interp``, which has no table: the
    port's plan is held to ``np.interp`` below)."""
    _, data_bins = jparams.used_bins(cfg.nfft, cfg.num_data_bins)
    out = {
        "sync_kernels": jfs._kernels(cfg),
        "idft": jmod._idft_mats(cfg.nfft),
        "idft_data_bins": jmod._idft_bin_mats(cfg.nfft, data_bins),
        "dft_data_bins": jeq._dft_bins_mats(cfg.nfft, cfg.num_data_bins),
        "dft_synch_bins": jsync._dft_synch_bins(cfg.nfft,
                                                cfg.num_synch_bins),
    }
    for name in jchan.CHANNELS_SISO:
        out[f"cir_{name}"] = jchan.channel_taps(name)
    for mod in jmodulation.BITS_PER_SYMBOL:
        out[f"points_{mod}"], out[f"point_bits_{mod}"] = \
            jmodulation._constellation_table(mod)
    if cfg.pilot_grid != "none":
        out.update(pilot_values=jpilots.pilot_values(cfg),
                   pilot_interp_cir=jpilots._cir_interp_matrix(cfg))
    if fo_range is not None:
        out["cfo_bank"] = jcfo.cfo_bank(cfg, fo_range)
        out["dsss_code"] = jcfo.dsss_code(dsss)
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_config_matches_jax(name):
    jcfg, tcfg = getattr(jparams, name), getattr(tparams, name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for prop in DERIVED:
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    assert tcfg.symbol_pattern() == jcfg.symbol_pattern()
    for nb in (tcfg.num_data_bins, tcfg.num_synch_bins):
        assert tparams.used_bins(tcfg.nfft, nb) == jparams.used_bins(
            jcfg.nfft, nb)
    np.testing.assert_array_equal(tzc.zc_for_config(tcfg),
                                  jzc.zc_for_config(jcfg))
    np.testing.assert_array_equal(tzc.delay_search_matrix(tcfg),
                                  jzc.delay_search_matrix(jcfg))


@pytest.mark.parametrize("name", ["GOLDEN64", "LTE1024"])
def test_port_tables_equal_jax_tables(name):
    jcfg = getattr(jparams, name)
    ours = port_tables(port_cfg(jcfg))
    theirs = jax_tables(jcfg)
    assert ours.keys() == theirs.keys()
    ours_t = tables_to_device(ours, "cpu")
    theirs_t = tables_to_device(theirs, "cpu")
    for key in ours:
        assert ours_t[key].dtype == theirs_t[key].dtype, key
        if key == "sync_kernels":
            # factored into one product per synch symbol, the float64 sums
            # round differently: the float32 results agree to an ulp of
            # the largest entry (|K_d| <= L)
            tol = 2 * np.finfo(np.float32).eps * jcfg.mm
            torch.testing.assert_close(ours_t[key], theirs_t[key],
                                       rtol=0, atol=tol)
        else:
            assert torch.equal(ours_t[key], theirs_t[key]), key


def test_tables_to_device_rejects_other_dtypes():
    with pytest.raises(TypeError):
        tables_to_device({"t": np.zeros(3, np.float64)}, "cpu")


def test_port_imports_no_jax():
    """Every module of the port imports, in a fresh interpreter, without
    loading jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import lte_gnu_radio_code_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or\n"
        "             k.startswith(('jax.', 'lte_gnu_radio_code_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    repo = pathlib.Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("grid", [dict(pilot_grid="lte", pilot_spacing=4),
                                  dict(pilot_grid="random", ref_sigs=0.3)],
                         ids=["lte", "random"])
def test_pilot_qam_and_legacy_tables_equal_jax(grid):
    """The tables this slice added: constellations, pilot values, the
    transform-domain interpolator, the CFO bank and the DSSS code exactly;
    the linear interpolator's (left, weight) plan against np.interp."""
    jcfg = dataclasses.replace(jparams.GOLDEN64, **grid).validate()
    fo_range, dsss = (0.0, -1500.0, 1500.0), 12
    ours = port_tables(port_cfg(jcfg), fo_range, dsss)
    theirs = jax_tables(jcfg, fo_range, dsss)
    plan = {"pilot_interp_left", "pilot_interp_weight"}
    assert ours.keys() - plan == theirs.keys() and plan <= ours.keys()
    ours_t = tables_to_device(ours, "cpu")
    theirs_t = tables_to_device(theirs, "cpu")
    for key in ("pilot_values", "pilot_interp_cir", "cfo_bank", "dsss_code",
                "points_QAM16", "point_bits_QAM16", "points_QAM64",
                "point_bits_QAM64", "points_QPSK", "points_BPSK"):
        assert ours_t[key].dtype == theirs_t[key].dtype, key
        assert torch.equal(ours_t[key], theirs_t[key]), key
    p_signed, _, d_signed, _ = jparams.pilot_bin_plan(jcfg)
    h = np.random.default_rng(0).standard_normal(len(p_signed))
    left, w = ours["pilot_interp_left"], ours["pilot_interp_weight"]
    np.testing.assert_allclose(h[left] + w * (h[left + 1] - h[left]),
                               np.interp(d_signed, p_signed, h), atol=1e-6)
    assert "pilot_values" not in port_tables(port_cfg(jparams.GOLDEN64))


@pytest.mark.parametrize("case", [0, 1])
def test_profiles_equal_jax(case):
    """The SDR profiles, the numerology derived from them and the
    configurations they give, field by field."""
    assert tparams.SDR_PROFILES == jparams.SDR_PROFILES
    prof = tparams.SDR_PROFILES[case]
    args = (prof["channel_band"], prof["bin_spacing"], prof["CP_type"])
    assert tparams.derive_numerology(*args) == \
        jparams.derive_numerology(*args)
    for kw in ({}, dict(num_symbols=48, snr_db=20.0)):
        assert dataclasses.asdict(tparams.config_from_profile(prof, **kw)) \
            == dataclasses.asdict(jparams.config_from_profile(prof, **kw))
    with pytest.raises(ValueError):
        tparams.derive_numerology(1e6, 15e3, "Short")


def test_pls_config_equal_jax():
    """PLSConfig with its default and the shipped profile: every field,
    property and bin layout."""
    assert tparams.PLS_PROFILES == jparams.PLS_PROFILES
    props = ("nfft", "cp_len", "symb_len", "num_synch_bins", "subband_size",
             "num_subbands", "key_len", "num_data_symb", "num_synch_symb",
             "total_num_symb", "frame_len")
    for kw in ({}, tparams.PLS_PROFILES[0], dict(pvt_info_len=16,
                                                 num_data_bins=8)):
        ours, ref = tparams.PLSConfig(**kw), jparams.PLSConfig(**kw)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        for name in props:
            assert getattr(ours, name) == getattr(ref, name), name
        for fn in ("used_data_bins", "used_synch_bins", "symbol_pattern"):
            assert getattr(ours, fn)() == getattr(ref, fn)(), fn
