"""The port's IQ rings against jrc_tpu.runtime's on the CPU: the same pushes
and pops give byte-equal blocks, counts and drops (layout, wrap-around,
overflow, saturation at ±32767), the native ring equals the numpy ring
reached with ``native=False``, ``pop_block(out=)`` fills the caller's
buffer, a threaded producer loses nothing, and a failed build raises."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu import runtime as jrt  # noqa: E402
from jrc_tpu_torch import runtime as rt  # noqa: E402
from tests.torch_parity import THREADS  # noqa: E402,F401 (the one-thread pool)


def _rings(kind, capacity, **kw):
    """(reference ring, port native ring, port numpy ring) of one kind."""
    if kind == "fc32":
        return jrt.IQRing(capacity), rt.IQRing(capacity), rt.IQRing(capacity, native=False)
    return (jrt.IQRing16(capacity, **kw), rt.IQRing16(capacity, **kw),
            rt.IQRing16(capacity, native=False, **kw))


def _same_block(blocks):
    ref = blocks[0]
    for b in blocks[1:]:
        assert (b is None) == (ref is None)
        if ref is not None:
            assert b.dtype == ref.dtype and b.shape == ref.shape
            assert b.tobytes() == ref.tobytes()


def test_native_library_builds_and_is_used():
    assert rt.load_library() is not None
    assert rt.library_path().is_file()
    assert "build/jrc_tpu_torch_runtime" in str(rt.library_path())
    assert rt.IQRing(64).native and not rt.IQRing(64, native=False).native
    assert jrt.IQRing(64).native  # the comparison below is native against native
    assert rt.SC16_SCALE == jrt.SC16_SCALE
    assert rt.mean_power(np.ones(4, np.complex64)) == 1.0  # the library's jrc_mean_power


@pytest.mark.parametrize("kind", ["fc32", "sc16"])
def test_ring_block_layout_matches(kind):
    rings = _rings(kind, 1 << 14)
    x = (np.arange(5000) + 1j * np.arange(5000)).astype(np.complex64) / 8192
    assert [r.push(x) for r in rings] == [5000] * 3
    assert len({r.capacity for r in rings}) == 1
    for _ in range(3):  # zero history, real history, then not enough buffered
        _same_block([r.pop_block(2048, 512, 256) for r in rings])
        assert len({r.available() for r in rings}) == 1
    b = rt.IQRing(1 << 14)
    b.push(x)
    blk = b.pop_block(2048, 512, 256)
    assert np.all(blk[:256] == 0)
    np.testing.assert_array_equal(blk[256 : 256 + 2048], x[:2048])
    np.testing.assert_array_equal(blk[256 + 2048 :], x[2048 : 2048 + 512])


@pytest.mark.parametrize("kind,seed", [("fc32", 0), ("sc16", 1), ("sc16", 2)])
def test_ring_random_pushes_and_pops_match(kind, seed):
    """Random chunk sizes through a small ring: wrap-around, overflow with
    drops, history kept across a full ring, every pop byte-equal."""
    rng = np.random.default_rng(seed)
    rings = _rings(kind, 1 << 10)
    n_blocks = 0
    for _ in range(60):
        n = int(rng.integers(1, 700))
        x = (rng.normal(0, 0.3, n) + 1j * rng.normal(0, 0.3, n)).astype(np.complex64)
        if kind == "sc16" and rng.integers(2):
            q = np.clip(np.rint(x.view(np.float32) * 32767.0), -32767, 32767).astype(np.int16)
            accepted = [r.push_sc16(q.reshape(-1, 2) if rng.integers(2) else q) for r in rings]
        else:
            accepted = [r.push(x) for r in rings]
        assert len(set(accepted)) == 1
        while rng.integers(3):
            blocks = [r.pop_block(256, 64, 32) for r in rings]
            _same_block(blocks)
            if blocks[0] is None:
                break
            n_blocks += 1
        assert len({r.dropped() for r in rings}) == 1
        assert len({r.available() for r in rings}) == 1
    assert n_blocks > 20 and rings[0].dropped() > 0


def test_ring_overflow_drops():
    for r in (rt.IQRing(1 << 8), rt.IQRing(1 << 8, native=False), rt.IQRing16(1 << 8)):
        assert r.push(np.ones(1000, np.complex64)) == 256
        assert r.dropped() == 744


@pytest.mark.parametrize("full_scale", [1.0, 0.25])
def test_sc16_quantization_saturates_like_the_reference(full_scale):
    rings = _rings("sc16", 1 << 8, full_scale=full_scale)
    x = np.array([0, 0.5, -0.5, 1.0, -1.0, 1.7, -3.0, 1e-5, 2.5 / 32767, 0.99999],
                 np.float32) * full_scale
    x = (x + 1j * x[::-1]).astype(np.complex64)
    for r in rings:
        r.push(x)
    blocks = [r.pop_block(len(x), 0, 0) for r in rings]
    _same_block(blocks)
    assert blocks[1].min() == -32767 and blocks[1].max() == 32767
    # float (n, 2) input is the same samples
    for r in rings[1:]:
        r.push(x.view(np.float32).reshape(-1, 2))
        assert r.pop_block(len(x), 0, 0).tobytes() == blocks[0].tobytes()


@pytest.mark.parametrize("n", [1, 3, 4, 5, 4099, 9000])
def test_sc16_quantizer_rounds_ties_and_odd_lengths_like_the_reference(n):
    """Every length class of the quantizer (its blocks of eight floats, the
    tail, more than one stack chunk), ties at .5 (to even), ±inf and values
    just inside and outside full scale: byte-equal to the reference's ring
    and to the numpy ring; a NaN quantizes as in the reference's ring."""
    rng = np.random.default_rng(n)
    f = rng.uniform(-1.2, 1.2, 2 * n).astype(np.float32)
    ties = (rng.integers(-32770, 32770, 2 * n) + 0.5).astype(np.float32) / np.float32(32767.0)
    f = np.where(rng.integers(3, size=2 * n) == 0, ties, f).astype(np.float32)
    special = np.array([np.inf, -np.inf, 1.0, -1.0, 32767.5 / 32767, -32766.5 / 32767, 0.0],
                       np.float32)
    f[-len(special):] = special[-len(f):]
    x = f.view(np.complex64)
    rings = _rings("sc16", 1 << 14)
    assert [r.push(x) for r in rings] == [n] * 3
    blocks = [r.pop_block(n, 0, 0) for r in rings]
    _same_block(blocks)
    assert np.abs(blocks[1].astype(np.int32)).max() <= 32767
    f[0] = np.nan
    ref, native, _ = _rings("sc16", 1 << 14)
    for r in (ref, native):
        r.push(f.view(np.complex64))
    _same_block([ref.pop_block(n, 0, 0), native.pop_block(n, 0, 0)])


@pytest.mark.parametrize("kind", ["fc32", "sc16"])
def test_pop_block_into_a_given_buffer(kind):
    _, native, plain = _rings(kind, 1 << 12)
    x = (np.arange(3000) / 4096 + 0.25j).astype(np.complex64)
    shape = (64 + 1024 + 128,) if kind == "fc32" else (64 + 1024 + 128, 2)
    dtype = np.complex64 if kind == "fc32" else np.int16
    for r in (native, plain):
        r.push(x)
        want = r.pop_block(1024, 128, 64)
        # a torch tensor's numpy view, as the streamer's staging buffers are
        out = torch.empty(shape, dtype=torch.complex64 if kind == "fc32" else torch.int16).numpy()
        r2 = type(r)(1 << 12, native=r.native)
        r2.push(x)
        got = r2.pop_block(1024, 128, 64, out=out)
        assert got is out and out.tobytes() == want.tobytes()
        assert r2.pop_block(1024, 128, 64, out=out) is not None
        assert r2.pop_block(1024, 128, 64, out=out) is None  # 952 left: out untouched or not, no pop
        for bad in (np.empty(shape, np.float64), np.empty((5,) + shape[1:], dtype),
                    np.empty((2 * shape[0],) + shape[1:], dtype)[::2]):
            with pytest.raises(ValueError, match="out"):
                r2.pop_block(1024, 128, 64, out=bad)


def test_numpy_ring_preserves_history_across_wrap():
    for r in (rt.IQRing(16, native=False), rt.IQRing(16)):
        x = (np.arange(1, 100) + 0j).astype(np.complex64)
        assert r.push(x[:16]) == 16
        b = r.pop_block(8, 0, 4)
        np.testing.assert_array_equal(b[4:].real, np.arange(1, 9))
        assert r.push(x[16:32]) == 4  # 8 unread samples and 4 of history stay
        b2 = r.pop_block(8, 0, 4)
        np.testing.assert_array_equal(b2[:4].real, np.arange(5, 9))
        np.testing.assert_array_equal(b2[4:].real, np.arange(9, 17))


def test_threaded_producer_consumer():
    r = rt.IQRing(1 << 12)
    n_total = 200_000
    src = (np.arange(n_total) % 997 + 1j).astype(np.complex64)
    consumed = []

    def producer():
        pos = 0
        while pos < n_total:
            n = r.push(src[pos : pos + 512])
            pos += 512
            if n < 512:
                time.sleep(0.0005)

    t = threading.Thread(target=producer)
    t.start()
    deadline = time.time() + 20
    out = np.empty(1024, np.complex64)
    got = 0
    while time.time() < deadline:
        if r.pop_block(1024, 0, 0, out=out) is None:
            if not t.is_alive() and r.available() < 1024:
                break
            time.sleep(0.0002)
            continue
        consumed.append(out.copy())
        got += 1024
    t.join(timeout=20)
    assert not t.is_alive()
    # conservation: consumed + still-buffered + dropped == produced
    assert got + r.available() + r.dropped() == n_total
    if r.dropped() == 0:
        flat = np.concatenate(consumed)
        np.testing.assert_array_equal(flat, src[: len(flat)])


def test_failed_build_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(rt, "_lib", None)
    monkeypatch.setattr(rt, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ there
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        rt.IQRing(64)
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.undo()
    monkeypatch.setattr(rt, "_lib", None)
    monkeypatch.setattr(rt, "BUILD_ROOT", tmp_path / "build2")
    monkeypatch.setattr(rt, "SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        rt.IQRing16(64)
    assert rt.IQRing(64, native=False).push(np.ones(3, np.complex64)) == 3  # asked for explicitly
