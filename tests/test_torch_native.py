"""The port's native ring buffer and chunker (``runtime/native.py``):
``tests/test_native.py``'s seven cases against the port, and the port's
ring and chunker against the JAX package's on one stream (the same bytes
and the same chunks).  The library is built from ``native/ringbuf.cc``
into ``build/native/``; the port never loads the JAX package's build."""

import threading

import numpy as np
import pytest
import torch

from lte_gnu_radio_code_tpu.runtime import native as jnative
from lte_gnu_radio_code_tpu_torch.runtime import native


@pytest.fixture(scope="module")
def lib():
    return native.load_library()


def test_ring_roundtrip(lib):
    r = native.NativeRing(1024)
    x = (np.arange(100) + 1j * np.arange(100)).astype(np.complex64)
    assert r.write(x) == 100
    assert r.available == 100
    back = r.read(100)
    assert back.dtype == torch.complex64 and back.device.type == "cpu"
    np.testing.assert_array_equal(back.numpy(), x)
    assert r.available == 0


def test_ring_wraparound(lib):
    r = native.NativeRing(128)
    total_in, total_out = [], []
    rng = np.random.default_rng(0)
    for _ in range(50):
        x = (rng.standard_normal(37) + 1j * rng.standard_normal(37)
             ).astype(np.complex64)
        w = r.write(torch.from_numpy(x))        # a CPU tensor goes in too
        total_in.append(x[:w])
        total_out.append(r.read(23).numpy())
    total_out.append(r.read(10000).numpy())
    a = np.concatenate(total_in)
    b = np.concatenate(total_out)
    np.testing.assert_array_equal(b, a[:len(b)])


def test_ring_backpressure(lib):
    r = native.NativeRing(64)
    x = np.ones(100, dtype=np.complex64)
    assert r.capacity == 64
    assert r.write(x) == 64    # full
    assert r.space == 0
    assert r.write(x) == 0
    assert native.NativeRing(100).capacity == 128    # a power of two


def test_ring_peek(lib):
    r = native.NativeRing(64)
    x = np.arange(10).astype(np.complex64)
    r.write(x)
    np.testing.assert_array_equal(r.peek(5).numpy(), x[:5])
    assert r.available == 10   # peek does not consume
    np.testing.assert_array_equal(r.read(10).numpy(), x)


def test_chunker_carry(lib):
    r = native.NativeRing(4096)
    c = native.NativeChunker(r, chunk=100, max_quantum=7)
    x = np.arange(250).astype(np.complex64)
    r.write(x)
    chunks = []
    while (out := c.pump()) is not None:
        assert out.shape == (100,) and out.dtype == torch.complex64
        chunks.append(out.numpy())
    assert len(chunks) == 2
    np.testing.assert_array_equal(np.concatenate(chunks), x[:200])
    assert c.staged == 50       # leftover carried for the next pump


def test_spsc_threaded(lib):
    """Producer and consumer threads, GNU Radio's scheduler topology."""
    r = native.NativeRing(1 << 12)
    n = 200_000
    src = (np.random.default_rng(1).standard_normal(n)
           .astype(np.float32)).astype(np.complex64)
    out = np.empty(n, dtype=np.complex64)

    def produce():
        sent = 0
        while sent < n:
            sent += r.write(src[sent:sent + 1024])

    got = [0]

    def consume():
        while got[0] < n:
            chunk = r.read(min(777, n - got[0])).numpy()
            out[got[0]:got[0] + len(chunk)] = chunk
            got[0] += len(chunk)

    tp = threading.Thread(target=produce)
    tc = threading.Thread(target=consume)
    tp.start()
    tc.start()
    tp.join(timeout=60)
    tc.join(timeout=60)
    assert not tp.is_alive() and not tc.is_alive()
    np.testing.assert_array_equal(out, src)


def test_native_staging_feeds_streaming_rx(lib):
    """The whole host path: a faded frame -> the ring in pieces of at most
    4095 samples -> the chunker -> the port's StreamingRx on the CPU; zero
    BER on the frame, and the same outputs as pushing the chunks of the
    buffer directly."""
    from lte_gnu_radio_code_tpu.reference_cpu import golden as G
    from lte_gnu_radio_code_tpu_torch.models import stream_rx
    from lte_gnu_radio_code_tpu_torch.runtime.stream import StreamingRx
    from lte_gnu_radio_code_tpu_torch.utils.params import GOLDEN64

    cfg = GOLDEN64
    bits = np.random.default_rng(0).integers(0, 2, cfg.num_bits)
    rx = G.apply_channel(G.tx_frame(cfg, bits), G.channel_taps("Fading"),
                         max_impulse=64).astype(np.complex64)
    chunk = 640

    ring = native.NativeRing(1 << 16)
    chunker = native.NativeChunker(ring, chunk=chunk)
    srx = StreamingRx(cfg, chunk, device="cpu")
    outs, pos = [], 0
    while pos < len(rx):
        pos += ring.write(rx[pos:pos + 4095])
        while (c := chunker.pump()) is not None:
            outs.append(srx.push(c))
    outs.append(srx.finish())
    assert chunker.staged == len(rx) % chunk

    direct = StreamingRx(cfg, chunk, device="cpu")
    whole = len(rx) // chunk * chunk
    ref = [direct.push(c) for c in torch.from_numpy(
        rx[:whole]).reshape(-1, chunk)] + [direct.finish()]
    for a, b in zip(outs, ref):
        for x, y in zip(a, b):
            assert torch.equal(x, y)

    ids = torch.cat([o.block_ids for o in outs])
    ph = torch.cat([o.phasors for o in outs])[ids >= 0]
    order = torch.argsort(ids[ids >= 0])
    hard = stream_rx.hard_decide(cfg, ph[order]).reshape(-1).numpy()
    nb = min(len(hard), len(bits))
    assert nb > 0 and np.mean(hard[:nb] != bits[:nb]) == 0.0


def test_port_ring_equals_jax_ring(lib):
    """One stream written to both packages' rings in the same uneven
    pieces and pumped through both chunkers (max_quantum 4095): the same
    chunks, the same staged carry, the same bytes left to read."""
    rng = np.random.default_rng(7)
    n = 50_000
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    sizes = rng.integers(1, 4096, 64)
    rings = native.NativeRing(1 << 14), jnative.NativeRing(1 << 14)
    chunkers = (native.NativeChunker(rings[0], 6000),
                jnative.NativeChunker(rings[1], 6000))
    got = ([], [])
    pos = 0
    for s in sizes:
        w = [ring.write(x[pos:pos + s]) for ring in rings]
        assert w[0] == w[1]
        pos += w[0]
        for k in range(2):
            while (c := chunkers[k].pump()) is not None:
                got[k].append(np.asarray(c))
        assert chunkers[0].staged == chunkers[1].staged
        assert rings[0].available == rings[1].available
    assert len(got[0]) == len(got[1]) > 0
    for a, b in zip(*got):
        assert a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(rings[0].peek(100).numpy(),
                                  rings[1].peek(100))
    np.testing.assert_array_equal(np.concatenate(got[0]),
                                  x[:6000 * len(got[0])])


def test_builds_into_build_dir_not_native(lib):
    """The port's library comes from native/ringbuf.cc, built under
    build/native/; it is neither the JAX package's .so in native/ nor its
    packaged _ringbuf extension."""
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    assert "ringbuf" not in path.name and path.name.startswith("libtorch_")
