"""The port's streaming ingest against jrc_tpu on the CPU.

``BlockStreamer``: the same capture in the same random chunking (random
chunk sizes, random interleave of push and process, on the sc16 wire a
random mix of quantizing pushes and native int16 pushes) through both
packages' streamers, fc32 and sc16, static and SIG-driven dynamic, then
``flush`` twice. Both must yield the same number of results with ``valid``,
``crc_ok``, ``sig_ok``, ``start``, ``payload`` (dynamic also ``mcs``,
``payload_len``, ``packet_type_bit``, ``chan_est_ok``) exactly equal,
``snr_db`` within 1e-3 dB on valid slots and ``chan_est`` within
1e-5 · max|h| on live slots (torch.fft and complex division round differently
from the reference's DFT matmul and pair form), and the same stats. The three
``flush`` cases of tests/test_runtime.py run through both as well.

The plain versions of K2 and K3 on an int16 stream: exactly what they give on
the dequantized stream, and K2 against the reference's Pallas front end in
interpret mode on the dequantized stream (triggers exact, ``a`` within 1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu.config import MCS, PacketType  # noqa: E402
from jrc_tpu.io.stream import BlockStreamer as JBlockStreamer  # noqa: E402
from jrc_tpu.ops import cplx as cx, detect_pallas as dp  # noqa: E402
from jrc_tpu_torch.io.stream import BlockStreamer  # noqa: E402
from jrc_tpu_torch.models import streaming as tst  # noqa: E402
from jrc_tpu_torch.ops import detect_cuda, gather_cuda, sync, wire  # noqa: E402
from tests.torch_parity import CFG, JCFG, np_of, specs, tx_frame  # noqa: E402

BLOCK_LEN, N_SUPER, MAX_FRAMES, MAXP = 1 << 13, 3, 16, 64
SPEC, JSPEC = specs(MCS.QPSK_3_4, 40)
EXACT = ("valid", "crc_ok", "sig_ok", "start", "payload")
EXACT_DYNAMIC = EXACT + ("mcs", "payload_len", "packet_type_bit", "chan_est_ok")


@pytest.fixture(scope="module")
def frames():
    """[the static frame, a BPSK-1/2 frame, an NDP frame], bench CFO."""
    return [tx_frame(specs(m, nb, pt)[1], text)[0] for m, nb, pt, text in (
        (MCS.QPSK_3_4, 40, PacketType.DATA, b"stream parity"),
        (MCS.BPSK_1_2, 16, PacketType.DATA, b"bpsk"),
        (MCS.QPSK_1_2, 12, PacketType.NDP, b"ndp"))]


def _capture(rng, frames, n):
    """Noise at 3e-3 (about 40 dB under the frames: a lower floor leaves the
    SNR estimate to float32 rounding) with ``frames`` in turn at random gaps,
    some straddling superblock boundaries → (capture, number placed)."""
    cap = (rng.normal(0, 3e-3, (n, 2)) @ [1, 1j]).astype(np.complex64)
    pos, k = int(rng.integers(300, 1200)), 0
    while pos + len(frames[k % len(frames)]) < n - 8:
        f = frames[k % len(frames)]
        cap[pos : pos + len(f)] += f
        pos += len(f) + int(rng.integers(700, 2600))
        k += 1
    return cap, k


def _plan(rng, n, sc16):
    """[(lo, hi, push as native int16, drain afterwards)] covering [0, n)."""
    plan, i = [], 0
    while i < n:
        m = int(rng.integers(1, 3 * BLOCK_LEN))
        plan.append((i, min(i + m, n), bool(sc16 and rng.integers(2)), bool(rng.integers(2))))
        i += m
    return plan


def _quantize(x):
    return np.clip(np.rint(x.view(np.float32) * 32767.0), -32767, 32767
                   ).astype(np.int16).reshape(-1, 2)


def _as_numpy(res):
    out = {}
    for f in res._fields:
        v = getattr(res, f)
        out[f] = v.numpy() if isinstance(v, torch.Tensor) else (
            np_of(v) if isinstance(v, cx.CArray) else np.asarray(v))
    return out


def _run(streamer, cap, plan):
    results = []
    for lo, hi, native, drain in plan:
        if native:
            streamer.push_sc16(_quantize(cap[lo:hi]))
        else:
            streamer.push(cap[lo:hi])
        if drain:
            results += [_as_numpy(r) for r in streamer.process_available()]
    results += [_as_numpy(r) for r in streamer.flush()]
    n_before = len(results)
    results += [_as_numpy(r) for r in streamer.flush()]  # idempotent: contributes nothing
    assert len(results) == n_before
    return results


def _assert_same_results(ours, ref, exact):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        valid = b["valid"]
        for f in exact:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        np.testing.assert_allclose(a["snr_db"][valid], b["snr_db"][valid], atol=1e-3)
        if "chan_est" in b and b["chan_est_ok"].any():
            live = b["chan_est_ok"]
            scale = np.abs(b["chan_est"][live]).max()
            np.testing.assert_allclose(a["chan_est"][live], b["chan_est"][live], rtol=0,
                                       atol=1e-5 * scale)


def _streamers(dynamic, wire_name, **kw):
    common = dict(block_len=BLOCK_LEN, max_frames=MAX_FRAMES, max_payload=MAXP, wire=wire_name,
                  **kw)
    return (BlockStreamer(CFG, None if dynamic else SPEC, device="cpu", **common),
            JBlockStreamer(JCFG, None if dynamic else JSPEC, **common))


@pytest.mark.parametrize("dynamic,wire_name,seed", [
    (False, "fc32", 0), (False, "sc16", 1), (True, "fc32", 2), (True, "sc16", 3)],
    ids=["static-fc32", "static-sc16", "dynamic-fc32", "dynamic-sc16"])
def test_streamer_random_chunking_matches_reference(frames, dynamic, wire_name, seed):
    rng = np.random.default_rng(100 + seed)
    n = BLOCK_LEN * N_SUPER
    cap, n_placed = _capture(rng, frames if dynamic else frames[:1], n)
    assert n_placed >= 8
    plan = _plan(rng, n, wire_name == "sc16")
    ours, ref = _streamers(dynamic, wire_name)
    assert (ours.span, ours.halo, ours.left_hist) == (ref.span, ref.halo, ref.left_hist)
    res_ours, res_ref = _run(ours, cap, plan), _run(ref, cap, plan)
    _assert_same_results(res_ours, res_ref, EXACT_DYNAMIC if dynamic else EXACT)
    assert ours.stats == type(ours.stats)(**vars(ref.stats))
    assert ours.stats.frames == ours.stats.crc_ok == n_placed and ours.stats.dropped_samples == 0
    if dynamic:
        assert sum(int(r["chan_est_ok"].sum()) for r in res_ours) == n_placed // 3

    # and one scan_rx over the whole capture finds the same (start, payload) set
    if not dynamic:
        halo = tst.frame_window_samples(CFG, SPEC) + CFG.fft_len
        whole = torch.from_numpy(np.concatenate([cap, np.zeros(halo, np.complex64)]))
        if wire_name == "sc16":
            whole = wire.dequantize(torch.from_numpy(_quantize(whole.numpy())), wire.dq_scale())
        from jrc_tpu_torch import tables
        oracle = tst.scan_rx(CFG, SPEC, tables.from_numpy(CFG, SPEC, "cpu"), whole, BLOCK_LEN,
                             N_SUPER, max_frames_per_block=MAX_FRAMES)
        want = sorted((int(s), bytes(p)) for s, p, v in zip(
            oracle.start.numpy(), oracle.payload.numpy(), oracle.valid.numpy()) if v)
        got = sorted((k * ours.span + int(s), bytes(p)) for k, r in enumerate(res_ours)
                     for s, p, v in zip(r["start"], r["payload"], r["valid"]) if v)
        assert got == want


@pytest.mark.parametrize("case", ["several buffered superblocks", "tail in the halo region"])
def test_streamer_flush_cases_match_reference(frames, case):
    """flush() alone after one push: 2.5 superblocks of frames (drain first,
    then pad), and a frame whose trigger lies past the span of the padded
    block (a second zero span); a repeat flush dispatches nothing."""
    frame = frames[0]
    rng = np.random.default_rng(7)

    def noise(n):  # as in _capture: keeps the SNR estimate off float32 rounding
        return (rng.normal(0, 3e-3, (n, 2)) @ [1, 1j]).astype(np.complex64)

    ours, ref = _streamers(False, "fc32", ring_capacity=8 * BLOCK_LEN)
    if case == "several buffered superblocks":
        n = int(2.5 * BLOCK_LEN)
        cap = noise(n)
        pos, nf = 600, 0
        while pos + len(frame) < n - 100:
            cap[pos : pos + len(frame)] += frame
            pos += len(frame) + 900
            nf += 1
    else:
        pos, nf = ours.span + 16, 1
        n = pos + len(frame) + 8
        assert ours.span < n < ours.span + ours.halo
        cap = noise(n)
        cap[pos : pos + len(frame)] += frame
    results = []
    for s in (ours, ref):
        s.push(cap)
        results.append([_as_numpy(r) for r in s.flush()])
        blocks = s.stats.blocks
        assert list(s.flush()) == [] and s.stats.blocks == blocks
    _assert_same_results(results[0], results[1], EXACT)
    assert ours.stats == type(ours.stats)(**vars(ref.stats))
    assert ours.stats.crc_ok == nf


def test_streamer_arguments():
    with pytest.raises(ValueError, match="wire"):
        BlockStreamer(CFG, SPEC, block_len=BLOCK_LEN, device="cpu", wire="sc8")
    with pytest.raises(ValueError, match="block_len"):
        BlockStreamer(CFG, SPEC, block_len=1000, device="cpu")
    with pytest.raises(ValueError, match="push_sc16"):
        BlockStreamer(CFG, SPEC, block_len=BLOCK_LEN, device="cpu").push_sc16(
            np.zeros((4, 2), np.int16))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BlockStreamer(CFG, SPEC, block_len=BLOCK_LEN)
    s = BlockStreamer(CFG, None, block_len=BLOCK_LEN, device="cpu", pipeline_depth=3, wire="sc16",
                      full_scale=0.5)
    assert len(s._slots) == 4 and s._slots[0].host.dtype == torch.int16
    assert s._dq == float(np.float32(0.5 / 32767.0))


# ------------------------------------------------- K2 and K3 on the sc16 wire


def _sc16_stream(rng, frames, n, full_scale):
    cap, _ = _capture(rng, frames, n)
    q = np.clip(np.rint(cap.view(np.float32) * np.float32(32767.0 / full_scale)),
                -32767, 32767).astype(np.int16).reshape(-1, 2)
    return torch.from_numpy(q), wire.dq_scale(full_scale)


DETECT_KW = dict(threshold=0.6, min_n_peaks=10, max_peak_distance=160, lag=16, win=32, pwin=48)


@pytest.mark.parametrize("full_scale", [1.0, 0.37])
def test_plain_kernels_on_int16_equal_the_dequantized_stream(frames, full_scale):
    rng = np.random.default_rng(5)
    q, dq = _sc16_stream(rng, frames, 3 * BLOCK_LEN + 77, full_scale)
    x = wire.dequantize(q, dq)
    assert x.dtype == torch.complex64 and x.shape == (q.shape[0],)
    np.testing.assert_array_equal(
        x.real.numpy(), q[:, 0].numpy().astype(np.float32) * np.float32(full_scale / 32767.0))
    for got, want in zip(detect_cuda.detect_front_end(q, dq=dq, **DETECT_KW),
                         detect_cuda.detect_front_end_plain(x, **DETECT_KW)):
        assert torch.equal(got, want)
    starts = torch.from_numpy(rng.integers(-500, q.shape[0] + 500, 40))
    omega = torch.from_numpy(rng.uniform(-0.02, 0.02, 40).astype(np.float32))
    n0 = torch.from_numpy(rng.integers(0, 160, 40))
    for width in (383, 1168):
        for rot in (None, (omega, None), (omega, n0)):
            for s in (starts, starts.to(torch.int32)):
                assert torch.equal(gather_cuda.gather_rows(q, s, width, rot=rot, dq=dq),
                                   gather_cuda.gather_rows_plain(x, s, width, rot=rot))
    # the stream functions hand both through unchanged
    det_q = sync.detect_frames_stream(CFG, q, BLOCK_LEN, 2, 384, dq=dq)
    det_x = sync.detect_frames_stream(CFG, x, BLOCK_LEN, 2, 384)
    assert int(det_x.valid.sum()) >= 5
    for a, b in zip(det_q, det_x):
        assert torch.equal(a, b)


def test_int16_stream_needs_its_scale_and_nothing_is_guessed():
    q = torch.zeros((4096, 2), dtype=torch.int16)
    x = torch.zeros(4096, dtype=torch.complex64)
    s = torch.zeros(3, dtype=torch.int64)
    for fn in (gather_cuda.gather_rows, gather_cuda.gather_rows_plain):
        with pytest.raises(ValueError, match="dq"):
            fn(q, s, 100)
        with pytest.raises(ValueError, match="dq"):
            fn(x, s, 100, dq=1.0)
        with pytest.raises(TypeError):
            fn(q.reshape(-1), s, 100, dq=1.0)
        with pytest.raises(ValueError, match="int16"):
            fn(q.to(torch.int32), s, 100, dq=1.0)
    for fn in (detect_cuda.detect_front_end, detect_cuda.detect_front_end_plain):
        with pytest.raises(ValueError, match="dq"):
            fn(q, **DETECT_KW)
        with pytest.raises(ValueError, match="dq"):
            fn(x, dq=1.0, **DETECT_KW)
    # off the CPU an int16 stream goes to the kernel, never to the plain version
    with pytest.raises((RuntimeError, ValueError)):
        gather_cuda.gather_rows(q.to("meta"), s.to("meta"), 100, dq=1.0)
    with pytest.raises((RuntimeError, ValueError)):
        detect_cuda.detect_front_end(q.to("meta"), dq=1.0, **DETECT_KW)


def test_plain_detect_on_int16_matches_pallas_on_the_dequantized_stream(frames):
    n = dp.CHUNK_ROWS * dp.LANE
    q, dq = _sc16_stream(np.random.default_rng(6), frames, n, 1.0)
    x = wire.dequantize(q, dq).numpy()
    a_re, a_im, first, count = dp.detect_front_end(
        jnp.asarray(x.real), jnp.asarray(x.imag), interpret=True, **DETECT_KW)
    a, first_t, count_t = detect_cuda.detect_front_end(q, dq=dq, **DETECT_KW)
    n_seg = -(-n // 128)
    assert int(count_t.sum()) >= 4
    np.testing.assert_array_equal(first_t.numpy(), np.asarray(first[:n_seg]))
    np.testing.assert_array_equal(count_t.numpy(), np.asarray(count[:n_seg]))
    np.testing.assert_allclose(a.real.numpy(), np.asarray(a_re[:n]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a.imag.numpy(), np.asarray(a_im[:n]), rtol=1e-5, atol=1e-5)
