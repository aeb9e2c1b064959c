"""The port's PLS key exchange (``ops/pls.py``, ``models/pls.py``,
``cli/pls_demo.py``) against the JAX package and its numpy oracle
(``reference_cpu/pls.py``) on the CPU, on numpy inputs made from a seed,
and the port's counterparts of ``tests/test_pls.py``'s nine cases.

Exact: the codebook, the synch mask and the reference symbols (the port's
own copies), PMI bits, timing locks and recovered key bits.  Within
tolerance: the SVD 1e-5, TX and RX 2e-5 on injected unitaries.  The two
packages draw their unitaries and noise from different generators, so the
exchanges are compared on injected ones."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lte_gnu_radio_code_tpu.cli import pls_demo as jdemo
from lte_gnu_radio_code_tpu.models import pls as JM
from lte_gnu_radio_code_tpu.ops import pls as JO
from lte_gnu_radio_code_tpu.reference_cpu import pls as P
from lte_gnu_radio_code_tpu.reference_cpu.golden import CHANNELS_MIMO2
from lte_gnu_radio_code_tpu.utils.params import PLSConfig as JCfg
from lte_gnu_radio_code_tpu_torch.cli import pls_demo
from lte_gnu_radio_code_tpu_torch.models import pls as M
from lte_gnu_radio_code_tpu_torch.ops import pls as O
from lte_gnu_radio_code_tpu_torch.utils.params import PLSConfig

CFG, JCFG = PLSConfig(), JCfg()
KEY = np.array([0, 0, 0, 1, 1, 0, 1, 1], dtype=np.int32)
D = 40                                  # a delay past the cp (16)


def _sym_channel(seed=3, taps=1):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, 2, taps)) + 1j * rng.standard_normal(
        (2, 2, taps))
    a[1, 0] = a[0, 1]
    return a


def _delayed_flat():
    g = np.array([[1.0 + 0.2j, 0.45j], [0.3 - 0.1j, 0.9 + 0.3j]])
    h = np.zeros((2, 2, D + 1), complex)
    h[:, :, D] = g
    return h


def _delayed_fading():
    """CHANNELS_MIMO2["Fading"] shifted by D (tests/test_pls.py)."""
    f2 = CHANNELS_MIMO2["Fading"]
    taps = max(len(f2[r][t]) for r in range(2) for t in range(2))
    h = np.zeros((2, 2, D + taps), complex)
    for r in range(2):
        for t in range(2):
            h[r, t, D:D + len(f2[r][t])] = f2[r][t]
    return h


def _unitaries(seed, lead=()):
    """Seeded unitaries [*lead, S, SB, 2, 2] (complex64) as the oracle's
    unitary_gen makes them."""
    rng = np.random.default_rng(seed)
    u = np.stack([P.unitary_gen(JCFG, rng) for _ in range(int(np.prod(lead,
                                                                      dtype=int)))])
    return u.reshape(*lead, *u.shape[1:]).astype(np.complex64)


def test_tables_equal_jax():
    """The port's own copies of the codebook, the synch mask and the
    reference symbols equal the oracle's; drawing the references leaves the
    global numpy state alone."""
    np.testing.assert_array_equal(O._codebook(CFG),
                                  P.codebook(JCFG).astype(np.complex64))
    np.testing.assert_array_equal(O._synch_mask(CFG), P.synch_mask(JCFG))
    state = np.random.get_state()
    O._ref_signal.cache_clear()
    ours = O._ref_signal(CFG)
    after = np.random.get_state()
    assert state[0] == after[0] and np.array_equal(state[1], after[1]) and \
        state[2:] == after[2:]
    np.testing.assert_array_equal(ours, P.ref_signal(JCFG))
    for k in range(3):
        np.testing.assert_array_equal(O._synch_freq(CFG)[k],
                                      JO._synch_freq(JCFG)[k])


def test_random_unitary_equals_jax_construction():
    """With the same input matrix the phase fix makes Q unique: the port's
    construction equals the JAX package's within rounding; random_unitary
    gives unitaries of the asked shape from the generator."""
    rng = np.random.default_rng(0)
    m = (rng.uniform(0, 1, (6, 2, 2)) + 1j * rng.uniform(0, 1, (6, 2, 2))
         ).astype(np.complex64)
    q, r = jnp.linalg.qr(jnp.asarray(m))
    d = jnp.diagonal(r, axis1=-2, axis2=-1)
    ref = np.asarray(q * (d / jnp.abs(d))[..., None, :])
    np.testing.assert_allclose(O.unitary_of(torch.from_numpy(m)).numpy(),
                               ref, atol=1e-5, rtol=0)
    u = O.random_unitary(torch.Generator().manual_seed(1), (3, 4), 2)
    assert u.shape == (3, 4, 2, 2) and u.dtype == torch.complex64
    eye = u @ u.conj().transpose(-1, -2)
    torch.testing.assert_close(eye, torch.eye(2, dtype=u.dtype).expand_as(
        eye), atol=1e-5, rtol=0)


def test_svd2x2_equals_jax():
    """Random matrices and the rank-1 corner within 1e-5 of the JAX
    package's svd2x2.  The diagonal corners (the axis fallback, either
    order) and the zero matrix give JAX's singular values and singular
    vectors up to a phase; a column whose first entry is an exact zero takes
    the phase of that zero's sign, which the matrix products leave to the
    implementation (the JAX package's own batched and single calls differ
    there), so those columns are held up to that sign."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((64, 2, 2)) +
         1j * rng.standard_normal((64, 2, 2))).astype(np.complex64)
    a[2] = np.outer([1, 1j], [0.5, 2 - 1j])
    ours = O.svd2x2(torch.from_numpy(a))
    ref = JO.svd2x2(jnp.asarray(a))
    for x, y in zip(ours, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5,
                                   rtol=0)
    diag = np.stack([np.diag([2.0, 1.0]), np.diag([1.0, 3.0j]),
                     np.zeros((2, 2))]).astype(np.complex64)
    u, s, v = (t.numpy() for t in O.svd2x2(torch.from_numpy(diag)))
    for i in range(3):
        ju, js, jv = (np.asarray(t) for t in JO.svd2x2(jnp.asarray(diag[i])))
        np.testing.assert_allclose(s[i], js, atol=1e-6)
        np.testing.assert_allclose(np.abs(u[i]), np.abs(ju), atol=1e-6)
        np.testing.assert_allclose(np.abs(v[i]), np.abs(jv), atol=1e-6)


def test_svd2x2_matches_numpy_phase_normalised():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((32, 2, 2)) +
         1j * rng.standard_normal((32, 2, 2))).astype(np.complex64)
    u, s, v = (t.numpy() for t in O.svd2x2(torch.from_numpy(a)))
    for i in range(32):
        un, sn, vhn = np.linalg.svd(a[i])
        vn = np.conj(vhn).T
        un = un @ np.diag(np.exp(-1j * np.angle(un[0, :])))
        vn = vn @ np.diag(np.exp(-1j * np.angle(vn[0, :])))
        np.testing.assert_allclose(s[i], sn, rtol=2e-4)
        np.testing.assert_allclose(u[i], un, atol=2e-4)
        np.testing.assert_allclose(v[i], vn, atol=2e-4)


def test_codebook_and_precoder_mapping_match_oracle():
    f_o = P.bits_to_precoders(JCFG, KEY)
    f = O.bits_to_precoders(CFG, torch.from_numpy(KEY)).numpy()
    np.testing.assert_allclose(f, f_o, atol=1e-6)
    pmi, bits = O.pmi_estimate(CFG, torch.from_numpy(
        f_o.astype(np.complex64)))
    np.testing.assert_array_equal(bits.numpy(), KEY)
    jpmi, _ = JO.pmi_estimate(JCFG, jnp.asarray(f_o.astype(np.complex64)))
    np.testing.assert_array_equal(pmi.numpy(), np.asarray(jpmi))


def test_pmi_bits_equal_jax_on_noisy_precoders():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((5, CFG.num_data_symb, CFG.num_subbands, 2, 2)) +
         1j * rng.standard_normal((5, CFG.num_data_symb, CFG.num_subbands,
                                   2, 2))).astype(np.complex64)
    _, bits = O.pmi_estimate(CFG, torch.from_numpy(x))
    assert bits.shape == (5, 8)
    for b in range(5):
        np.testing.assert_array_equal(
            bits[b].numpy(), np.asarray(JO.pmi_estimate(JCFG,
                                                        jnp.asarray(x[b]))[1]))


def test_transmit_and_receive_equal_jax_and_oracle():
    """transmit on injected unitaries (a batch of three) within 2e-5 of
    the JAX package and 1e-5 of the oracle; receive on the channel's
    output: singular vectors within 2e-5, singular values within 2e-5 of
    their size, bits equal.  The channel is tests/test_pls.py's dispersive
    one, whose singular values lie apart; at the 1-tap channel's (0.06 %
    apart) a rounding of 1e-7 moves the singular vectors by ~1e-4 in
    either package."""
    ua = _unitaries(1, (3,))
    ref_sig = P.ref_signal(JCFG)
    tx = O.transmit(CFG, torch.from_numpy(ua)).numpy()
    assert tx.shape == (3, 2, CFG.frame_len)
    h = _sym_channel(7, taps=3)
    rx = M.mimo_channel(CFG, torch.from_numpy(tx), h).numpy()
    ours = O.receive(CFG, torch.from_numpy(rx))
    for b in range(3):
        np.testing.assert_allclose(tx[b], np.asarray(JO.transmit(
            JCFG, jnp.asarray(ua[b]), ref_sig)), atol=2e-5, rtol=0)
        np.testing.assert_allclose(tx[b], P.transmit(JCFG, ua[b], ref_sig),
                                   atol=1e-5)
        jrx = np.asarray(JM.mimo_channel(JCFG, jnp.asarray(tx[b]), h))
        np.testing.assert_allclose(rx[b], jrx, atol=2e-5, rtol=0)
        ref = JO.receive(JCFG, jnp.asarray(rx[b]), ref_sig)
        for x, y, tol in zip(ours[:3], ref[:3], (dict(atol=2e-5, rtol=0),
                                                 dict(atol=0, rtol=2e-5),
                                                 dict(atol=2e-5, rtol=0))):
            np.testing.assert_allclose(x[b].numpy(), np.asarray(y), **tol)
        np.testing.assert_array_equal(ours[3][b].numpy(), np.asarray(ref[3]))


def test_receive_matches_oracle():
    rng = np.random.default_rng(2)
    ua = P.unitary_gen(JCFG, rng)
    ref_sig = P.ref_signal(JCFG)
    tx = P.transmit(JCFG, ua, ref_sig)
    rx = P.mimo_channel(JCFG, tx, _sym_channel())[:, :JCFG.frame_len]
    lsv_o, _, _ = P.receive(JCFG, rx, ref_sig)
    lsv = O.receive(CFG, torch.from_numpy(rx.astype(np.complex64)))[0]
    np.testing.assert_allclose(lsv.numpy(), lsv_o, atol=1e-3)


@pytest.mark.parametrize("delay", [0, 7, D, 64])
def test_sync_lock_equals_jax(delay):
    """The lock on a frame delayed through a flat 2x2 channel with AWGN
    equals the JAX package's, and the delay."""
    g = np.array([[1.0 + 0.2j, 0.45j], [0.3 - 0.1j, 0.9 + 0.3j]])
    h = np.zeros((2, 2, delay + 1), complex)
    h[:, :, delay] = g
    tx = O.transmit(CFG, torch.from_numpy(_unitaries(delay, (2,))))
    noise = np.random.default_rng(delay).standard_normal(
        (2, 2, CFG.frame_len + 64, 2)).view(np.complex128)[..., 0]
    rx = M.mimo_channel(CFG, tx, h, 20.0, out_len=CFG.frame_len + 64,
                        noise=torch.from_numpy(noise.astype(np.complex64)))
    ptr = O.sync_lock(CFG, rx, 64)
    for b in range(2):
        jptr = JO.sync_lock(JCFG, jnp.asarray(rx[b].numpy()), 64)
        assert int(ptr[b]) == int(jptr) == delay
    with pytest.raises(ValueError):
        O.sync_lock(CFG, rx[..., :CFG.frame_len], 64)


def _jax_exchange(h, key, u, noise, snr_db, max_delay=None):
    """The JAX package's states on injected unitaries and noise."""
    ref = P.ref_signal(JCFG)
    ext = JCFG.frame_len + (max_delay or 0)

    def hop(tx, hh, nz):
        y = JM.mimo_channel(JCFG, tx, hh, out_len=ext)
        if snr_db is None:
            return y
        nv = jnp.mean(jnp.abs(tx) ** 2) * 10 ** (-snr_db / 10)
        return y + jnp.sqrt(nv / 2.0).astype(jnp.float32) * jnp.asarray(nz)

    def rx(y):
        if max_delay is None:
            return (*JO.receive(JCFG, y, ref), None)
        return JO.receive_synced(JCFG, y, ref, max_delay)

    tx = JO.transmit(JCFG, jnp.asarray(u), ref)
    lsv, _, _, _, pb = rx(hop(tx, h, noise[0]))
    tx_b = JO.transmit(JCFG, JO.rotated_precoder(
        lsv, JO.bits_to_precoders(JCFG, jnp.asarray(key))), ref)
    _, _, _, bits, pa = rx(hop(tx_b, np.swapaxes(h, 0, 1), noise[1]))
    return np.asarray(bits), pb, pa


@pytest.mark.parametrize("synced", [False, True])
def test_key_exchange_equals_jax_on_injected_draws(synced):
    """Four exchanges, each with its own key bits, on injected unitaries
    and noise: the recovered bits, errors and locks equal the JAX
    package's, exchange by exchange, noise-free and at 30 dB."""
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 2, (4, 8), dtype=np.int32)
    u = _unitaries(12, (4,))
    max_delay = 64 if synced else None
    ext = CFG.frame_len + (max_delay or 0)
    h = _delayed_fading() if synced else _sym_channel(9, taps=3)
    for snr_db in (None, 30.0):
        noise = (rng.standard_normal((2, 4, 2, ext)) + 1j *
                 rng.standard_normal((2, 4, 2, ext))).astype(np.complex64)
        kw = dict(unitaries=u, device="cpu",
                  noise=None if snr_db is None else tuple(
                      torch.from_numpy(n) for n in noise))
        if synced:
            bits, err, (pb, pa) = M.key_exchange_synced(
                CFG, keys, None, h, snr_db, max_delay, **kw)
        else:
            bits, err = M.key_exchange(CFG, keys, None, h, snr_db, **kw)
        for b in range(4):
            jbits, jpb, jpa = _jax_exchange(h, keys[b], u[b], noise[:, b],
                                            snr_db, max_delay)
            np.testing.assert_array_equal(bits[b].numpy(), jbits)
            assert int(err[b]) == int(np.sum(jbits != keys[b]))
            if synced:
                assert int(pb[b]) == int(jpb)
                assert int(pa[b]) == int(jpa)
        assert int(err.sum()) == 0


# -- tests/test_pls.py's nine cases on the port --------------------------------

@pytest.mark.parametrize("chan", ["ones", "sym_flat", "asym_flat",
                                  "sym_disp"])
def test_full_key_exchange_zero_errors(chan):
    h = {"ones": None,
         "sym_flat": _sym_channel(),
         "asym_flat": np.random.default_rng(5).standard_normal((2, 2, 1))
         + 1j * np.random.default_rng(6).standard_normal((2, 2, 1)),
         "sym_disp": _sym_channel(7, taps=3)}[chan]
    bits, err = M.key_exchange(CFG, KEY, torch.Generator().manual_seed(0),
                               h=h, device="cpu")
    assert int(err) == 0
    np.testing.assert_array_equal(bits.numpy(), KEY)


def test_key_exchange_with_noise():
    """60 dB: the unit-normalised 1-tap channel's singular values lie
    ~0.2 % apart, so the protocol needs noise well below that gap
    (tests/test_pls.py)."""
    _, err = M.key_exchange(CFG, KEY, torch.Generator().manual_seed(1),
                            h=_sym_channel(), snr_db=60.0, device="cpu")
    assert int(err) == 0


def test_key_exchange_matches_oracle_protocol():
    """Same channel, independent unitaries: both recover the same key."""
    h = _sym_channel(9)
    bits_o, err_o = P.key_exchange(JCFG, KEY, np.random.default_rng(4), h=h)
    bits, err = M.key_exchange(CFG, KEY, torch.Generator().manual_seed(2),
                               h=h, device="cpu")
    assert err_o == 0 and int(err) == 0
    np.testing.assert_array_equal(bits.numpy(), bits_o)


def test_longer_key():
    cfg = PLSConfig(pvt_info_len=16)
    key = np.random.default_rng(11).integers(0, 2, 16, dtype=np.int32)
    _, err = M.key_exchange(cfg, key, torch.Generator().manual_seed(3),
                            h=_sym_channel(12), device="cpu")
    assert int(err) == 0


def test_key_exchange_through_real_sync_beyond_cp():
    """The exchange through the ZC delay-search lock with a delay past the
    cp: the perfect-timing exchange fails (the lock is load-bearing), the
    synced one recovers the delay at both ends with zero errors, also over
    the delayed MIMO Fading channel and with AWGN; a batch of exchanges,
    each with its own key bits."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2, (3, 8), dtype=np.int32)
    gen = torch.Generator().manual_seed(1)
    h = _delayed_flat()
    _, err, (pb, pa) = M.key_exchange_synced(CFG, keys, gen, h, max_delay=64,
                                             device="cpu")
    assert err.tolist() == [0, 0, 0]
    assert pb.tolist() == [D] * 3 and pa.tolist() == [D] * 3
    _, err0 = M.key_exchange(CFG, keys, gen, h=h, device="cpu")
    assert int(err0.sum()) > 0
    _, err2, _ = M.key_exchange_synced(CFG, keys, gen, _delayed_fading(),
                                       max_delay=64, device="cpu")
    assert int(err2.sum()) == 0
    _, err3, _ = M.key_exchange_synced(CFG, keys, gen, h, snr_db=40.0,
                                       max_delay=64, device="cpu")
    assert int(err3.sum()) == 0


def test_batch_rows_equal_single_exchanges():
    keys = np.random.default_rng(21).integers(0, 2, (3, 8), dtype=np.int32)
    u = _unitaries(22, (3,))
    bits, err, locks = M.key_exchange_synced(
        CFG, keys, None, _delayed_fading(), max_delay=64, unitaries=u,
        device="cpu")
    for b in range(3):
        one = M.key_exchange_synced(CFG, keys[b], None, _delayed_fading(),
                                    max_delay=64, unitaries=u[b],
                                    device="cpu")
        assert torch.equal(one[0], bits[b]) and int(one[1]) == int(err[b])
        assert int(one[2][0]) == int(locks[0][b])


def test_exchange_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: tests/test_torch_cuda.py "
                    "holds the exchange there")
    with pytest.raises(RuntimeError):
        M.key_exchange(CFG, KEY, None, unitaries=_unitaries(0))
    with pytest.raises(RuntimeError):
        pls_demo.main(["--iters", "1"])


@pytest.mark.parametrize("channel", ["ones", "symmetric", "dispersive"])
def test_cli_equals_jax_cli(channel, capsys):
    """cli.pls_demo --device cpu against the JAX package's CLI with the
    same flags: the same keys (both draw them from one numpy generator),
    zero errors, every key recovered."""
    args = ["--iters", "3", "--seed", "5", "--channel", channel, "--json"]
    ours = pls_demo.main(args + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    ref = jdemo.main(args)
    capsys.readouterr()
    assert out == ours
    assert [r["key"] for r in ours] == [r["key"] for r in ref]
    for r, j in zip(ours, ref):
        assert r["bit_errors"] == j["bit_errors"] == 0
        assert r["recovered"] == r["key"] == j["recovered"]
