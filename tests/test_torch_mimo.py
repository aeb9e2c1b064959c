"""The port's 2x2 MIMO (``models/mimo.py``: SpMult and the Alamouti STCode,
``ops/channel.py``: ``mimo2_taps``, ``apply_channel_mimo``) against the
JAX package on numpy inputs made from a seed, on the CPU, and the port's
counterparts of ``tests/test_mimo.py``'s seven cases.

Exact: locks, delays, found and hard bits (a hard bit may differ only
where the JAX phasor lies within the phasor tolerance of a decision
boundary, ``torch_parity.assert_bits_equal_or_on_boundary``; the tests
print how many do).  Within tolerance: TX 2e-5, the channel 1e-5, phasors
and channel estimates 2e-4, the search 2e-3 (K4's, the JAX package's
tests/test_pallas.py).

The search runs K4's plain twin at ZC slice 0 of the config's sequence
(the CPU branch of ``kernels/sync_search.py:sync_corr_abs``), where the
JAX package runs ``sync_spectra`` and a delay einsum; a test pins that the
slice, not the single-synch config's own sequence, reaches the tables."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lte_gnu_radio_code_tpu.models import mimo as jmimo
from lte_gnu_radio_code_tpu.ops import channel as jchan
from lte_gnu_radio_code_tpu.ops import sync as jsync
from lte_gnu_radio_code_tpu.ops import zadoff_chu as jzc
from lte_gnu_radio_code_tpu.utils.params import OFDMConfig
from lte_gnu_radio_code_tpu_torch import kernels
from lte_gnu_radio_code_tpu_torch.kernels import mimo_detect, sync_search
from lte_gnu_radio_code_tpu_torch.models import mimo
from lte_gnu_radio_code_tpu_torch.ops import channel, fast_sync
from lte_gnu_radio_code_tpu_torch.ops import sync as tsync
from lte_gnu_radio_code_tpu_torch.ops.zadoff_chu import zc_for_config
from lte_gnu_radio_code_tpu_torch.utils import params as tparams
from lte_gnu_radio_code_tpu_torch.utils.tables import device_table
from torch_parity import assert_bits_equal_or_on_boundary, port_cfg

PHASOR_ATOL = 2e-4
CPU = torch.device("cpu")


def _cfg(**kw):
    """tests/test_mimo.py's configuration."""
    base = dict(synch_dat=(2, 2), num_ofdm_symb=48, num_ant_txrx=2,
                snr_db=100.0)
    base.update(kw)
    return OFDMConfig(**base).validate()


def _jcfg1(cfg):
    return OFDMConfig(**{**cfg.__dict__, "synch_dat": (1, cfg.synch_dat[1]),
                         "num_ant_txrx": 1}).validate()


def _bits(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, 2, (*shape, cfg.num_bits),
                                                dtype=np.int32)


def _buffer(cfg, tx, seed, snr_db):
    """tx [..., 2, T] through the JAX package's 2x2 Fading channel, padded
    to frame_len + nfft - 1, plus seeded AWGN at snr_db over the TX power
    (the chain's noise convention)."""
    n = cfg.frame_len + cfg.nfft - 1
    h = jchan.mimo2_taps("Fading")
    rx = np.stack([np.asarray(jchan.apply_channel_mimo(jnp.asarray(t), h))
                   for t in tx.reshape(-1, 2, tx.shape[-1])])
    rx = np.pad(rx, ((0, 0), (0, 0), (0, n - rx.shape[-1])))
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape)
    sig_pow = np.mean(np.abs(tx.reshape(-1, 2 * tx.shape[-1])) ** 2, -1)
    nv = np.asarray(jchan.noise_variance(
        dataclasses.replace(cfg, snr_db=snr_db), sig_pow))
    y = rx + np.sqrt(nv / 2)[:, None, None] * noise
    return y.reshape(*tx.shape[:-1], n).astype(np.complex64)


@pytest.mark.parametrize("mod", ["QPSK", "QAM16"])
def test_tx_equals_jax(mod):
    """Both modes' TX, one frame and a frame axis, within 2e-5."""
    cfg = _cfg(modulation=mod)
    pcfg = port_cfg(cfg)
    bits = _bits(cfg, 0, (3, 2))
    ours = mimo.tx_frame_mimo(pcfg, torch.from_numpy(bits)).numpy()
    assert ours.shape == (3, 2, cfg.frame_len)
    for b in range(3):
        ref = np.asarray(jmimo.tx_frame_mimo(cfg, jnp.asarray(bits[b])))
        np.testing.assert_allclose(ours[b], ref, atol=2e-5, rtol=0)
    stc = mimo.tx_frame_stcode(pcfg, torch.from_numpy(bits[:, 0])).numpy()
    for b in range(3):
        ref = np.asarray(jmimo.tx_frame_stcode(cfg, jnp.asarray(bits[b, 0])))
        np.testing.assert_allclose(stc[b], ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name,taps", [("Fading", None), ("Ideal", None),
                                       ("long", 300)])
def test_apply_channel_mimo_equals_jax(name, taps):
    """The conv1d form (mimo2_taps) and the FFT form (300 taps), with a
    frame axis and with max_impulse, within 1e-5 of the JAX package."""
    rng = np.random.default_rng(1)
    sig = (rng.standard_normal((2, 2, 700)) +
           1j * rng.standard_normal((2, 2, 700))).astype(np.complex64)
    if taps is None:
        h = channel.mimo2_taps(name)
        np.testing.assert_array_equal(h, jchan.mimo2_taps(name))
    else:
        h = ((rng.standard_normal((2, 2, taps)) +
              1j * rng.standard_normal((2, 2, taps))) / taps
             ).astype(np.complex64)
    ours = channel.apply_channel_mimo(torch.from_numpy(sig), h).numpy()
    padded = channel.apply_channel_mimo(torch.from_numpy(sig),
                                        torch.from_numpy(h),
                                        max_impulse=400).numpy()
    for b in range(2):
        ref = np.asarray(jchan.apply_channel_mimo(jnp.asarray(sig[b]),
                                                  jnp.asarray(h)))
        np.testing.assert_allclose(ours[b], ref, atol=1e-5, rtol=0)
        np.testing.assert_allclose(padded[b, :, :ref.shape[-1]], ref,
                                   atol=1e-5, rtol=0)
        assert padded.shape[-1] == 700 + max(400, h.shape[-1]) - 1
        # zero past the true taps (the FFT form to its rounding)
        assert np.abs(padded[b, :, ref.shape[-1]:]).max() <= 1e-5


def test_search_at_slice_zero_equals_jax_einsum():
    """K4's plain twin against ZC slice 0 of the two-symbol sequence gives
    the JAX receiver's |einsum| of the power-normalised spectra within
    2e-3; against the single-synch config's own sequence (another ZC) it
    does not.  Each sequence has its own tables."""
    cfg = _cfg()
    cfg1 = _jcfg1(cfg)
    pcfg, pcfg1 = port_cfg(cfg), port_cfg(cfg1)
    # the port's view is the JAX package's one pattern long
    assert mimo.search_config(pcfg) == dataclasses.replace(
        pcfg1, num_ofdm_symb=1 + cfg.synch_dat[1])
    tx = np.asarray(jmimo.tx_frame_mimo(cfg, jnp.asarray(_bits(cfg, 2,
                                                               (2,)))))
    y = _buffer(cfg, tx, 3, 30.0)
    n = y.shape[-1]
    n_trials = jsync.n_trials_for(cfg1, n)
    zc0 = jzc.zc_for_config(cfg)[:cfg.num_synch_bins]
    spectra = jsync.sync_spectra(cfg1, jnp.asarray(y[0]), n_trials)
    dse = jnp.asarray(jzc.delay_search_matrix(cfg1))
    ref = np.asarray(jnp.abs(jnp.einsum(
        "pl,dl->pd", spectra * jnp.conj(jnp.asarray(zc0))[None, :], dse)))
    x0 = torch.from_numpy(y[0])
    ours = sync_search.sync_corr_abs(pcfg1, x0, n_trials, zc=zc0).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-3, rtol=0)
    fft_form = fast_sync.sync_corr_abs_fft(pcfg1, x0, n_trials, zc=zc0)
    np.testing.assert_allclose(fft_form.numpy(), ref, atol=2e-3, rtol=0)
    own = sync_search.sync_corr_abs(pcfg1, x0, n_trials).numpy()
    assert len(zc_for_config(pcfg1)) == len(zc0)
    assert np.abs(own - ref).max() > 1.0
    assert fast_sync.zc_key(zc0) != fast_sync.zc_key(zc_for_config(pcfg1))
    for make in (fast_sync._conv_weights, fast_sync._zc_by_bin,
                 sync_search._kernels_t):
        assert not torch.equal(device_table(make, CPU, pcfg1),
                               device_table(make, CPU, pcfg1,
                                            fast_sync.zc_key(zc0)))
    with pytest.raises(ValueError):
        sync_search.sync_corr_abs(pcfg1, x0, n_trials, zc=zc_for_config(pcfg))


@pytest.mark.parametrize("mode", ["spmult", "stcode"])
@pytest.mark.parametrize("mod,snr_db,frame", [
    pytest.param("QPSK", 100.0, {}, id="QPSK-100.0"),
    pytest.param("QPSK", 12.0, {}, id="QPSK-12.0"),
    pytest.param("QAM16", 22.0, {}, id="QAM16-22.0"),
    pytest.param("QPSK", 12.0, dict(synch_dat=(2, 6), num_ofdm_symb=56),
                 id="QPSK-12.0-2x6-56sym")])
def test_rx_equals_jax(mode, mod, snr_db, frame):
    """rx_frame_mimo / rx_frame_stcode on one shared noisy buffer per
    frame, three frames as a frame axis: lock, delay, found, hard bits
    equal (up to phasors on a boundary), phasors and chan_freq within
    2e-4; each row of the batch equals that frame alone.  Also at synch_dat
    (2, 6) with 56 symbols (8 patterns a frame), a count whose (1, 6) view
    the JAX package's search also accepts."""
    cfg = _cfg(modulation=mod, snr_db=snr_db, **frame)
    pcfg = port_cfg(cfg)
    seed = {"QPSK": 10, "QAM16": 20}[mod] + int(snr_db)
    if mode == "spmult":
        bits = _bits(cfg, seed, (3, 2))
        jtx, jrx = jmimo.tx_frame_mimo, jmimo.rx_frame_mimo
        rx = mimo.rx_frame_mimo
    else:
        bits = _bits(cfg, seed, (3,))
        jtx, jrx = jmimo.tx_frame_stcode, jmimo.rx_frame_stcode
        rx = mimo.rx_frame_stcode
    tx = np.stack([np.asarray(jtx(cfg, jnp.asarray(b))) for b in bits])
    y = _buffer(cfg, tx, seed + 1, snr_db)
    n_trials, num_patterns = mimo.plan(pcfg, y.shape[-1])
    assert n_trials == jsync.n_trials_for(_jcfg1(cfg), y.shape[-1])
    ours = rx(pcfg, torch.from_numpy(y), n_trials, num_patterns)
    differ = 0
    for b in range(3):
        ref = jrx(cfg, jnp.asarray(y[b]), n_trials, num_patterns)
        for f in ("lock_ptr", "delay_idx", "found"):
            assert int(getattr(ours, f)[b]) == int(getattr(ref, f)), f
        np.testing.assert_allclose(ours.phasors[b].numpy(),
                                   np.asarray(ref.phasors),
                                   atol=PHASOR_ATOL, rtol=0)
        np.testing.assert_allclose(ours.chan_freq[b].numpy(),
                                   np.asarray(ref.chan_freq),
                                   atol=PHASOR_ATOL, rtol=0)
        differ += assert_bits_equal_or_on_boundary(
            ours.hard_bits[b].numpy(), np.asarray(ref.hard_bits),
            np.asarray(ref.phasors), cfg, PHASOR_ATOL)
        one = rx(pcfg, torch.from_numpy(y[b]), n_trials, num_patterns)
        assert torch.equal(one.hard_bits, ours.hard_bits[b])
        assert int(one.lock_ptr) == int(ours.lock_ptr[b])
        torch.testing.assert_close(one.phasors, ours.phasors[b], atol=1e-6,
                                   rtol=0)
    print(f"{mode} {mod} {snr_db} dB: {differ} symbols differ on a "
          "boundary")
    if snr_db == 100.0:
        assert np.array_equal(ours.hard_bits.numpy(), bits)


def test_inv2x2_equals_jax():
    rng = np.random.default_rng(4)
    h = (rng.standard_normal((50, 2, 2)) +
         1j * rng.standard_normal((50, 2, 2))).astype(np.complex64)
    ours = mimo_detect.inv2x2(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jmimo._inv2x2(
        jnp.asarray(h))), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours @ h, np.broadcast_to(np.eye(2), h.shape),
                               atol=1e-4)


# The three shapes the detection runs at: tests/test_mimo.py's config (nfft
# 64, 24 data symbols x 60 bins), the reference's WIFIMIMOSM-A profile with
# synch_dat (2, 2) (6 x 56) and the benchmark's lte2048_2x2 (48 x 1200).
DETECT_CFGS = {
    "test-cfg": lambda: port_cfg(_cfg()),
    "wifimimosm-a": lambda: dataclasses.replace(tparams.config_from_profile(
        tparams.SDR_PROFILES[1]), synch_dat=(2, 2)).validate(),
    "lte2048_2x2": lambda: dataclasses.replace(
        tparams.LTE2048, synch_dat=(2, 6), num_ant_txrx=2,
        snr_db=12.0).validate()}


def _old_detect(cfg, fd, chan):
    """The detection as ``rx_frame_mimo`` ran it inline before the kernel
    pair, its ``_inv2x2`` and ``_unit_power`` with it."""
    def inv2x2(h):
        a, b = h[..., 0, 0], h[..., 0, 1]
        c, d = h[..., 1, 0], h[..., 1, 1]
        inv_det = 1.0 / (a * d - b * c)
        row0 = torch.stack([d, -b], -1)
        row1 = torch.stack([-c, a], -1)
        return torch.stack([row0, row1], -2) * inv_det[..., None, None]

    def unit_power(ph):
        p = (ph.abs() ** 2).mean((-2, -1), keepdim=True)
        return ph * torch.rsqrt(p.clamp_min(1e-30))

    dev = fd.device
    hd = chan[..., tsync._bins_on(dev, cfg.nfft, cfg.num_data_bins)]
    hd = hd.movedim(-1, -3)
    hh = hd.conj().transpose(-1, -2)
    eye = torch.eye(2, dtype=hd.dtype, device=dev)
    w = inv2x2(hh @ hd + (1.0 / cfg.snr_linear) * eye) @ hh
    yv = fd.movedim(-3, -1)[..., None]
    xhat = (w[..., None, :, :, :] @ yv)[..., 0]
    return unit_power(xhat.movedim(-1, -3))


def _c64(rng, *shape):
    return torch.from_numpy((rng.standard_normal(shape) + 1j *
                             rng.standard_normal(shape)).astype(np.complex64))


@pytest.mark.parametrize("lead", [(), (3,), (0,)], ids=["[]", "[3]", "[0]"])
@pytest.mark.parametrize("name", list(DETECT_CFGS))
def test_detect_twin_is_the_old_body(name, lead, monkeypatch):
    """``kernels/mimo_detect.py``: on CPU tensors the wrapper runs the twin,
    which gives the old inline body's phasors bit for bit, contiguous; a
    wrong dtype, shape or a non-contiguous input raises; its CUDA branch
    (launches recorded, not made) makes the two launches with the
    signatures' arity, one grid for both, none for zero frames."""
    from lte_gnu_radio_code_tpu_torch.kernels import _cuda
    from torch_parity import recorded_launch

    cfg = DETECT_CFGS[name]()
    kn, nb = cfg.num_data_symb, cfg.num_data_bins
    rng = np.random.default_rng(60)
    fd, chan = _c64(rng, *lead, 2, kn, nb), _c64(rng, *lead, 2, 2, cfg.nfft)
    bins = tsync._bins_on(CPU, cfg.nfft, nb)
    inv_snr = 1.0 / cfg.snr_linear
    want = _old_detect(cfg, fd, chan)
    twin = mimo_detect.detect_plain(fd, chan, bins, inv_snr)
    got = mimo_detect.detect(fd, chan, bins, inv_snr)
    assert torch.equal(twin, want) and torch.equal(got, want)
    assert got.shape == (*lead, 2, kn, nb) and got.is_contiguous()

    wrong = [(fd.to(torch.complex128), chan, bins),
             (fd, chan.to(torch.complex128), bins),
             (fd, chan, bins.to(torch.int32)),
             (fd[..., :1, :, :], chan, bins),
             (fd, chan[..., :1, :], bins),
             (fd, chan, bins[1:]),
             (fd[..., :-1], chan, bins)]
    if lead:
        wrong.append((fd, chan[None], bins))
    if fd.numel():      # an empty tensor is contiguous whatever its strides
        wrong += [(fd.mT.contiguous().mT, chan, bins),
                  (fd, chan.mT.contiguous().mT, bins)]
    for args in wrong:
        with pytest.raises(ValueError):
            mimo_detect.detect(*args, inv_snr)

    calls = []
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "launch", recorded_launch(calls))
    kernels.reset_launch_counts()
    out = mimo_detect.detect(fd, chan, bins, inv_snr)
    assert out.shape == fd.shape and out.is_contiguous()
    frames = int(np.prod(lead, dtype=int))
    if not frames:
        assert calls == [] and mimo_detect.launches == 0
        return
    assert [n for n, _ in calls] == ["mimo_detect_power",
                                     "mimo_detect_scale"]
    for n, args in calls:
        assert len(args) + 1 == len(_cuda.SIGNATURES[n]), n
    power, scale = calls[0][1], calls[1][1]
    assert scale[:-1] == power and scale[-1] == out.data_ptr()
    parts = -(-kn // mimo_detect.SYMBOLS) * -(-nb // mimo_detect.BLOCK)
    assert power[3:8] == (frames, kn, nb, cfg.nfft, parts)
    assert mimo_detect.launches == 2
    kernels.reset_launch_counts()


def test_wrong_configs_raise():
    with pytest.raises(ValueError):
        mimo.make_mimo_chain(tparams.GOLDEN64, device="cpu")
    with pytest.raises(ValueError):
        mimo.make_stcode_chain(port_cfg(_cfg(synch_dat=(2, 3),
                                             num_ofdm_symb=50)),
                               device="cpu")


def test_chains_run_on_the_card_unless_asked():
    """Without device the chains run on the CUDA device: where there is
    none they raise, and never move to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: tests/test_torch_cuda.py "
                    "holds the chains there")
    for make in (mimo.make_mimo_chain, mimo.make_stcode_chain):
        with pytest.raises(RuntimeError):
            make(port_cfg(_cfg()))


# -- tests/test_mimo.py's seven cases on the port's chains ----------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_mimo_spmult_zero_ber_fading():
    cfg = port_cfg(_cfg())
    step = mimo.make_mimo_chain(cfg, channel="Fading", device="cpu")
    r = step(_bits(cfg, 0, (2,)), generator=_gen(0))
    assert bool(r.found) and int(r.lock_ptr) == cfg.cp_len
    assert float(r.ber.max()) == 0.0


def test_mimo_spmult_moderate_snr():
    cfg = port_cfg(_cfg(snr_db=30.0))
    step = mimo.make_mimo_chain(cfg, channel="Fading", device="cpu")
    r = step(_bits(cfg, 1, (2,)), generator=_gen(1))
    assert bool(r.found)
    assert float(r.ber.max()) < 0.02


def test_mimo_rank1_channel_fails_as_physics_dictates():
    """The reference's MIMO 'Ideal' table is the all-ones (rank-1) matrix:
    two streams cannot be separated through it."""
    cfg = port_cfg(_cfg())
    step = mimo.make_mimo_chain(cfg, channel="Ideal", device="cpu")
    r = step(_bits(cfg, 2, (2,)), generator=_gen(2))
    assert float(r.ber.max()) > 0.05


def test_mimo_channel_estimate_matches_truth():
    cfg = port_cfg(_cfg())
    tx = mimo.tx_frame_mimo(cfg, torch.from_numpy(_bits(cfg, 3, (2,))))
    h = channel.mimo2_taps("Fading")
    rx = channel.apply_channel_mimo(tx, h, max_impulse=cfg.nfft)
    n_trials, _ = mimo.plan(cfg, rx.shape[-1])
    r = mimo.rx_frame_mimo(cfg, rx, n_trials, cfg.num_patterns - 1)
    hf_true = np.fft.fft(h, cfg.nfft, axis=-1)
    ratio = r.chan_freq.numpy()[:, :, 5] / hf_true[:, :, 5]
    np.testing.assert_allclose(ratio / ratio[0, 0], np.ones((2, 2)),
                               atol=2e-2)


def test_stcode_zero_ber_fading():
    cfg = port_cfg(_cfg())
    step = mimo.make_stcode_chain(cfg, channel="Fading", device="cpu")
    r = step(_bits(cfg, 3, ()), generator=_gen(3))
    assert bool(r.found) and int(r.lock_ptr) == cfg.cp_len
    assert float(r.ber) == 0.0


def test_stcode_works_on_rank1_channel():
    """Alamouti needs no spatial separability: it decodes through the
    rank-1 'Ideal' matrix where SpMult cannot."""
    cfg = port_cfg(_cfg())
    step = mimo.make_stcode_chain(cfg, channel="Ideal", device="cpu")
    r = step(_bits(cfg, 4, ()), generator=_gen(4))
    assert bool(r.found)
    assert float(r.ber) == 0.0


def test_stcode_beats_spmult_at_matched_rate():
    """Matched spectral efficiency (STC QAM16 == SpMult QPSK, 4 bits per
    bin per symbol): six frames each, as one batch."""
    stc_cfg = port_cfg(_cfg(snr_db=18.0, modulation="QAM16"))
    sp_cfg = port_cfg(_cfg(snr_db=18.0, modulation="QPSK"))
    stc = mimo.make_stcode_chain(stc_cfg, channel="Fading", device="cpu")
    sp = mimo.make_mimo_chain(sp_cfg, channel="Fading", device="cpu")
    b_stc = np.broadcast_to(_bits(stc_cfg, 5, ()), (6, stc_cfg.num_bits))
    b_sp = np.broadcast_to(_bits(sp_cfg, 6, (2,)), (6, 2, sp_cfg.num_bits))
    ber_stc = float(stc(b_stc.copy(), generator=_gen(5)).ber.mean())
    ber_sp = float(sp(b_sp.copy(), generator=_gen(6)).ber.mean())
    assert ber_stc < ber_sp


def test_chain_batch_rows_equal_single_frames():
    """A batch of frames through make_mimo_chain with an injected noise
    tensor: each row equals the same frame alone with its row of noise."""
    cfg = port_cfg(_cfg(snr_db=15.0))
    step = mimo.make_mimo_chain(cfg, device="cpu")
    n = cfg.frame_len + cfg.nfft - 1
    bits = _bits(cfg, 7, (3, 2))
    rng = np.random.default_rng(8)
    noise = torch.from_numpy((rng.standard_normal((3, 2, n)) + 1j *
                              rng.standard_normal((3, 2, n))
                              ).astype(np.complex64))
    r = step(bits, noise=noise)
    assert r.ber.shape == (3, 2) and r.hard_bits.shape == (3, 2,
                                                           cfg.num_bits)
    for b in range(3):
        one = step(bits[b], noise=noise[b])
        assert torch.equal(one.hard_bits, r.hard_bits[b])
        assert int(one.lock_ptr) == int(r.lock_ptr[b])
