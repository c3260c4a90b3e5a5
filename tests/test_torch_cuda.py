"""The port's CUDA kernels against their plain PyTorch versions, on a card:
K1-K3 (K1 also on soft values scaled by a noise variance, K2 and K3 also on
the int16 stream of the sc16 wire, K2's trigger selection alone on
synthetic front-end outputs) and the paths
through them, the streaming ingest on both wires, the JRC dwell (the pinned
dwells, and one step against the plain path), the link simulation (a
``link_curve`` point against the plain path and against the CPU), the radar
extras on the card against the CPU, the profiling kernels P1-P3, and the
antenna configurations, the chunk-parallel Viterbi and the interleaver on
the card against the CPU, and the captured CUDA graphs of ``jit=True``
(the streamer static, dynamic and mixed on both wires, and ``link_curve``)
against the eager launches, with the dynamic flat pass free of host syncs;
and the other compile sites captured against eager: ``jrc_step`` (the
state carried, the generator registered and restored after the warm-up,
a kept result unchanged, no host sync, a scene of host values refused),
``radar_frame``, and the sharded and batched executors on a world of one
over NCCL; on a host of two cards or more, over min(4, cards) NCCL ranks:
the dry run (``parallel/dryrun.py``), the batched executors captured
against eager, and the bench capture's ranks exiting after the teardown
(these skip below two cards).

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports neither jax nor the JAX package, so it also runs on a machine
that has no jax, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu_torch.config import MCS, OFDMConfig, PacketType  # noqa: E402
from jrc_tpu_torch import capture, tables  # noqa: E402
from jrc_tpu_torch.io.stream import BlockStreamer  # noqa: E402
from jrc_tpu_torch.kernels.registry import launch_counts, plain_kernels  # noqa: E402
from jrc_tpu_torch.models.streaming import (  # noqa: E402
    StreamingRx, StreamingRxDynamic, frame_window_samples_dynamic,
)
from jrc_tpu_torch.ops import (  # noqa: E402
    detect_cuda, gather_cuda, gather_pieces, shuffle_pieces, viterbi, viterbi_cuda, viterbi_pieces,
    wire,
)
from jrc_tpu_torch.ops.encoder import FrameSpec  # noqa: E402
from jrc_tpu_torch.runtime import quantize_sc16  # noqa: E402
import select_cases  # noqa: E402  (beside this file: 'tests' may name another package)

pytestmark = pytest.mark.cuda

CFG = OFDMConfig()
SPEC = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
DETECT_KW = dict(threshold=0.6, min_n_peaks=10, max_peak_distance=2 * CFG.sym_len,
                 lag=CFG.fft_len // 4, win=CFG.fft_len // 2,
                 pwin=int(1.5 * (CFG.fft_len // 2)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _soft_values(b, t, dev, erasures=0.2):
    rng = np.random.default_rng(b * 1000 + t)
    vals = rng.normal(0, 1, (b, 2 * t)).astype(np.float32)
    vals[rng.random(vals.shape) < erasures] = 0.0
    return torch.from_numpy(vals).to(dev)


@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("b,t,erasures", [
    (5, 100, 0.2), (3072, 576, 0.2),
    (64, 24, 0.2),  # the SIG call's length
    (9, 333, 0.2),  # an odd T, a B off the four frames of a block
    (7, 864, 0.2), (6, 2160, 0.2),  # the dynamic paths' lengths
    (9, 200, 1.0),  # all erasures: every compare a tie
    (3, 1, 0.2), (2, 7, 0.2),  # shorter than the code's memory
])
def test_viterbi_kernel_matches_plain(dev, b, t, erasures, route):
    """Soft values with erasures through the fused decoder on either
    decision route: bits exactly equal to the plain version's, one launch."""
    v = _soft_values(b, t, dev, erasures)
    trellis = tables.from_numpy(CFG, SPEC, dev).trellis
    before = launch_counts()["viterbi_decode"]
    got = viterbi_cuda.viterbi_decode(v, trellis, route=route)
    assert launch_counts()["viterbi_decode"] == before + 1
    assert got.dtype == torch.uint8 and got.shape == (b, t)
    assert torch.equal(got, viterbi.viterbi_decode_plain(v, trellis))


def test_viterbi_kernel_long_frame_takes_the_scratch_route(dev):
    """A 3100-byte BPSK-1/2 frame (24 864 steps) does not fit shared memory:
    the chooser takes the scratch route, and the bits still equal the plain
    version's; batch dimensions and ``n_out`` are kept."""
    t = 24864
    assert viterbi_cuda.decision_route(3, t) == "global"
    v = _soft_values(3, t, dev).reshape(3, 1, 2 * t)
    trellis = tables.from_numpy(CFG, SPEC, dev).trellis
    got = viterbi_cuda.viterbi_decode(v, trellis, n_out=t - 6)
    assert got.shape == (3, 1, t - 6)
    assert torch.equal(got, viterbi.viterbi_decode_plain(v, trellis, n_out=t - 6))


@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("b", [1, 5, 32, 33])
@pytest.mark.parametrize("kind", ["hard", "soft"])
def test_viterbi_kernel_row_extents_match_the_full_envelope(dev, b, route, kind):
    """K1 with each row's extent (``n_steps``) against K1 without it and the
    plain version with it: rows of ±1 (ties) or soft values with erasures,
    erased from extents mixed between 0 (all erasures) and past T, on either
    route; bits exactly equal, one launch each."""
    t = 300
    rng = np.random.default_rng(b * 7 + (kind == "hard"))
    v = _soft_values(b, t, "cpu")
    if kind == "hard":
        v = torch.sign(v)
    cases = [0, 1, 5, 6, 7, 100, t - 7, t - 6, t - 1, t, t + 9]
    extents = rng.choice(cases, b)
    extents[0] = 0  # an all-erasure row
    extents = torch.from_numpy(extents)
    for row, n in zip(v, extents.tolist()):
        row[2 * n :] = 0.0
    v, n_steps = v.to(dev), extents.to(dev)
    trellis = tables.from_numpy(CFG, SPEC, dev).trellis
    full = viterbi_cuda.viterbi_decode(v, trellis, route=route)
    before = launch_counts()["viterbi_decode"]
    got = viterbi_cuda.viterbi_decode(v, trellis, route=route, n_steps=n_steps)
    assert launch_counts()["viterbi_decode"] == before + 1
    assert torch.equal(got, full)
    assert torch.equal(got, viterbi.viterbi_decode_plain(v, trellis, n_steps=n_steps))
    i32 = viterbi_cuda.viterbi_decode(v, trellis, route=route, n_steps=n_steps.to(torch.int32))
    assert torch.equal(i32, full)


def test_viterbi_kernel_writes_the_longest_rows_steps(dev):
    """With ``entry`` the launch raises its call's ``viterbi_steps`` count to
    the longest row's extent + 6 (T at most) and writes T, in the row of the
    call begun last; without extents the longest row is T."""
    from jrc_tpu_torch.utils import profiling

    profiling.reset()
    t = 200
    v = torch.zeros((6, 2 * t), device=dev)
    trellis = tables.from_numpy(CFG, SPEC, dev).trellis
    want = []
    for extents in ([3, 50, 0, 7, 1, 2], [0] * 6, [190, 0, 0, 0, 0, 1], None):
        profiling.stamp("rx", "start", v)
        n = None if extents is None else torch.tensor(extents, device=dev)
        viterbi_cuda.viterbi_decode(v, trellis, n_steps=n, entry="rx")
        want.append((t if extents is None else min(max(extents) + 6, t), t))
    assert profiling.counts("rx", "viterbi_steps") == want
    profiling.reset()


def _dense_and_sparse(kind: str) -> np.ndarray:
    """2^19 samples of the benchmark's receive traffic over 1e-4 noise: the
    seven pinned mixed frames 2111 samples apart (dense), or one frame in
    the whole capture (sparse)."""
    frames = [f.samples for f in capture.load_mixed_frames()]
    rng = np.random.default_rng(0 if kind == "dense" else 1)
    cap = (rng.normal(0, 1e-4, (1 << 19, 2)) @ [1, 1j]).astype(np.complex64)
    pos, k = 700, 0
    while pos + len(frames[k % len(frames)]) < len(cap):
        f = frames[k % len(frames)]
        cap[pos : pos + len(f)] += f
        pos, k = pos + len(f) + 2111, k + 1
        if kind == "sparse":
            break
    return cap


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_captured_streamer_decodes_each_row_to_its_extent(dev, kind, monkeypatch):
    """``BlockStreamer(jit=True)`` at the live receiver's geometry (2^16-sample
    blocks, 32 slots, 3100-B envelope) on dense and sparse traffic: every
    call's result field-identical to the eager streamer whose K1 decodes
    every row to the envelope (``rx_frame_dynamic_values``, K1 without
    extents, ``rx_frame_dynamic_finish``), free slots included; the
    ``viterbi_steps`` count of each call is its longest row's extent + 6,
    under the envelope's T."""
    from jrc_tpu_torch.ops import dynamic_rx
    from jrc_tpu_torch.utils import profiling

    cap = _dense_and_sparse(kind)
    kw = dict(block_len=1 << 16, max_frames=32, max_payload=3100, pipeline_depth=2)
    t = dynamic_rx.max_trellis_bits(3100)

    def run(streamer):
        out = []
        for i in range(0, len(cap), 1 << 15):
            streamer.push(cap[i : i + (1 << 15)])
            out += _drain(streamer)
        return out

    profiling.reset()
    got = run(BlockStreamer(CFG, None, jit=True, **kw))
    steps = profiling.counts("rx", "viterbi_steps")
    profiling.reset()
    orig, longest = viterbi_cuda.viterbi_decode, []

    def full(values, trellis, n_out=None, route=None, *, n_steps=None, entry=None):
        if n_steps is not None:
            longest.append(int(viterbi.row_extents(n_steps, values.shape[-1] // 2).max()))
        return orig(values, trellis, n_out, route)

    monkeypatch.setattr(viterbi_cuda, "viterbi_decode", full)
    want = run(BlockStreamer(CFG, None, jit=False, **kw))
    assert len(got) == len(want) == len(longest) >= 6
    for k, (a, b) in enumerate(zip(got, want)):
        for f in b:
            assert torch.equal(a[f], b[f]), (k, f)
    # the capture's warm-up call counts once more, ahead of the replays
    assert steps[-len(got):] == [(n, t) for n in longest], (steps, longest)
    assert min(longest) < t
    if kind == "dense":
        assert sum(int(r["valid"].sum()) for r in got) >= 8 * len(got)


@pytest.mark.parametrize("noise_var", [0.05, 1e-4])
def test_soft_decode_frame_at_noise_var(dev, noise_var):
    """decode_frame(soft=True, noise_var) on 3072 copies of the pinned bench
    frame's data symbols (unit points) with noise of that variance drawn on
    the card: LLRs 1/noise_var times those at unit variance reach K1. Every
    frame CRC-clean with the pinned payload and seed, K1's bits exactly the
    plain version's on both routes, the call equal under plain_kernels()."""
    from jrc_tpu_torch.ops import decoder, encoder

    tab = tables.from_numpy(CFG, SPEC, dev)
    payload = torch.from_numpy(capture.load_bench_frame()[1]).to(dev)
    z0 = encoder.encode_frame(SPEC, tab, payload, 93) * 2  # QPSK's TX half undone
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = torch.randn((3072, *z0.shape), generator=gen, dtype=torch.complex64, device=dev)
    z = z0 + noise * float(np.sqrt(noise_var))
    before = launch_counts()["viterbi_decode"]
    got = decoder.decode_frame(SPEC, tab, z, soft=True, noise_var=noise_var)
    assert launch_counts()["viterbi_decode"] == before + 1
    assert bool(got.crc_ok.all()) and bool((got.payload == payload).all())
    assert bool((got.scrambler_seed == 93).all())
    values = decoder.frame_values(SPEC, tab, z, soft=True, noise_var=noise_var)
    want = viterbi.viterbi_decode_plain(values, tab.trellis)
    for route in ("shared", "global"):
        assert torch.equal(viterbi_cuda.viterbi_decode(values, tab.trellis, route=route), want)
    with plain_kernels():
        plain = decoder.decode_frame(SPEC, tab, z, soft=True, noise_var=noise_var)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(plain, f)), f


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_detect_kernel_matches_plain(dev, n_chunks):
    """STF-like plateaus in noise (one across the middle): triggers exactly
    equal, autocorrelation within rtol = atol = 1e-5."""
    n = n_chunks * 512 * 128
    rng = np.random.default_rng(n_chunks)
    x = (rng.normal(0, 0.1, n) + 1j * rng.normal(0, 0.1, n)).astype(np.complex64)
    block = rng.normal(0, 1, 16) + 1j * rng.normal(0, 1, 16)
    for pos in (1000, 5000, n // 2 - 200, n - 3000):
        x[pos : pos + 800] = np.tile(block, 50)
    xt = torch.from_numpy(x).to(dev)
    a_k, first_k, count_k = detect_cuda.detect_front_end(xt, **DETECT_KW)
    a_p, first_p, count_p = detect_cuda.detect_front_end_plain(xt, **DETECT_KW)
    assert int(count_p.sum()) >= 4
    assert torch.equal(first_k, first_p) and torch.equal(count_k, count_p)
    torch.testing.assert_close(torch.view_as_real(a_k), torch.view_as_real(a_p),
                               rtol=1e-5, atol=1e-5)


def _detect_kw(fft_len, cp_len, **over):
    kw = dict(threshold=0.6, min_n_peaks=10, max_peak_distance=2 * (fft_len + cp_len),
              lag=fft_len // 4, win=fft_len // 2, pwin=int(1.5 * (fft_len // 2)))
    kw.update(over)
    return kw


@pytest.mark.parametrize("n,fft_len,cp_len,over", [
    (3 * 4096 + 77, 64, 16, {}),  # off every multiple of 32, 128 and 4096
    (200, 64, 16, {}),  # below the margin
    (31, 64, 16, {}),  # below one warp row
    (40_000, 128, 32, {}),  # max_peak_distance 320, lag 32, windows 64 and 96
    (20_000, 64, 16, dict(win=63, pwin=33)),  # windows off the compiled pairs
    (20_000, 64, 16, dict(threshold=0.3, min_n_peaks=20)),  # noise triggers now and then
], ids=["off-multiple", "below-margin", "31", "mpd320", "generic-windows", "noise-triggers"])
def test_detect_kernel_edge_shapes(dev, n, fft_len, cp_len, over):
    """The stream is read as it is (no padded copy): one launch, triggers
    exactly equal, ``a`` exactly equal."""
    rng = np.random.default_rng(n)
    noise = 1.0 if "threshold" in over else 0.1
    x = (rng.normal(0, noise, n) + 1j * rng.normal(0, noise, n)).astype(np.complex64)
    if "threshold" not in over:
        block = rng.normal(0, 1, fft_len // 4) + 1j * rng.normal(0, 1, fft_len // 4)
        for pos in (60, n // 2 - 200, n - 700):
            if 0 <= pos < n:
                x[pos : pos + 50 * len(block)] = np.tile(block, 50)[: n - pos]
    xt = torch.from_numpy(x).to(dev)
    kw = _detect_kw(fft_len, cp_len, **over)
    before = launch_counts()["detect_front_end"]
    a_k, first_k, count_k = detect_cuda.detect_front_end(xt, **kw)
    assert launch_counts()["detect_front_end"] == before + 1
    a_p, first_p, count_p = detect_cuda.detect_front_end_plain(xt, **kw)
    if n >= 20_000:
        assert int(count_p.sum()) >= 2
    assert torch.equal(first_k, first_p) and torch.equal(count_k, count_p)
    assert torch.equal(torch.view_as_real(a_k), torch.view_as_real(a_p))


@pytest.mark.parametrize("n_rows,max_frames,opts", select_cases.CASES,
                         ids=select_cases.CASE_IDS)
def test_selection_kernel_matches_plain(dev, n_rows, max_frames, opts):
    """K2's trigger selection alone (the entry point's second launch) on
    synthetic K2 outputs, against the plain composition on the card (sort,
    ``detect_cuda._suppress``, ownership, ``_starts_and_cfo``): starts, CFO,
    valid flags and n_candidates bit for bit, and the ``detect_cands`` count
    it writes: the most candidates a row fed to the suppression, out of
    4·max_frames."""
    from jrc_tpu_torch.utils import profiling

    a, first, count, rows = (t.to(dev) if torch.is_tensor(t) else t
                             for t in select_cases.select_case(n_rows, max_frames, **opts))
    profiling.reset()
    profiling.stamp("rx", "start", a)
    got = detect_cuda.select(a, first, count, rows, select_cases.LAG, entry="rx")
    want = detect_cuda.select_plain(a, first, count, rows, select_cases.LAG)
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    fed = select_cases.candidates_fed(first.cpu(), rows)
    assert profiling.counts("rx", "detect_cands") == [(fed, 4 * max_frames)]
    profiling.reset()


def _captured_nodes(fn) -> tuple[torch.cuda.CUDAGraph, int]:
    """``fn()`` captured in a CUDA graph after one eager call → (the graph,
    its nodes: the kernels, copies and fills one call issues to the device,
    counted by ``cuGraphGetNodes`` with no profiler attached)."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    n = ctypes.c_size_t()
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    assert err == 0, f"cuGraphGetNodes returned {err}"
    return graph, n.value


def test_detect_frames_stream_is_two_device_operations(dev):
    """One ``detect_frames_stream`` call at the live receiver's shape (a
    2^16-sample block, 32 frame slots, the 3100-B halo): K2 and its
    selection, at most 10 device operations in the call's CUDA graph (the
    selection composed of PyTorch operations took 695 at this shape), and
    the graph's replay gives the eager call's result."""
    from jrc_tpu_torch.models import streaming as st
    from jrc_tpu_torch.ops import sync

    left = st.left_history_samples(CFG)
    halo = st.frame_window_samples_dynamic(CFG, 3100) + CFG.fft_len
    xp = torch.from_numpy(_dense_and_sparse("dense")[: left + 2**16 + halo]).to(dev)
    out = {}
    run = lambda: out.update(got=sync.detect_frames_stream(  # noqa: E731
        CFG, xp, 2**16, 1, left, max_frames=32))
    run()
    want = out["got"]
    graph, nodes = _captured_nodes(run)
    assert 2 <= nodes <= 10, nodes
    graph.replay()
    torch.cuda.synchronize()
    got = out["got"]
    assert int(got.valid.sum()) > 10
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name


def test_detect_kernel_refuses_a_window_it_does_not_take(dev):
    x = torch.zeros(4096, dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError, match="window"):
        detect_cuda.detect_front_end(x, **_detect_kw(256, 64))


@pytest.mark.parametrize("index_type", [np.int64, np.int32])
@pytest.mark.parametrize("width", [1, 2, 5, 383, 1168, 3328, 7568])
def test_gather_kernel_matches_plain(dev, width, index_type):
    """Starts clamped at both ends, every path's width and a few tiny ones:
    exactly equal without ``rot``, within ROT_ATOL · max|x| with it (with
    and without the n0 offset), one launch a call."""
    rng = np.random.default_rng(3)
    n = 50_000
    x = torch.from_numpy((rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)).to(dev)
    starts = torch.from_numpy(rng.integers(-500, n + 500, 777).astype(index_type)).to(dev)
    before = launch_counts()["gather_rows"]
    assert torch.equal(gather_cuda.gather_rows(x, starts, width),
                       gather_cuda.gather_rows_plain(x, starts, width))
    assert launch_counts()["gather_rows"] == before + 1
    omega = torch.from_numpy(rng.uniform(-0.02, 0.02, 777).astype(np.float32)).to(dev)
    n0 = torch.from_numpy(rng.integers(0, 320, 777).astype(index_type)).to(dev)
    atol = gather_cuda.ROT_ATOL * float(x.abs().max())
    for rot in ((omega, None), (omega, n0)):
        got = gather_cuda.gather_rows(x, starts, width, rot=rot)
        want = gather_cuda.gather_rows_plain(x, starts, width, rot=rot)
        assert float((torch.view_as_real(got) - torch.view_as_real(want)).abs().max()) <= atol


def test_gather_kernel_takes_an_unaligned_stream(dev):
    """A stream that starts 8 bytes off a 16-byte line (a slice)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.normal(size=9001) + 1j * rng.normal(size=9001))
                         .astype(np.complex64)).to(dev)[1:]
    starts = torch.from_numpy(rng.integers(-50, 9050, 301)).to(dev)
    for width in (383, 1168):
        assert torch.equal(gather_cuda.gather_rows(x, starts, width),
                           gather_cuda.gather_rows_plain(x, starts, width))


def test_extract_frames_batch_is_two_gather_launches(dev):
    """The derotation rides in K3: two launches, and the symbols equal the
    plain path's within the rotation's tolerance."""
    from jrc_tpu_torch.ops import sync

    rng = np.random.default_rng(5)
    n = 60_000
    x = torch.from_numpy((rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)).to(dev)
    trig = torch.from_numpy(rng.integers(0, n - 4096, 50)).to(dev)
    cfo = torch.from_numpy(rng.uniform(-3e-4, 3e-4, 50).astype(np.float32)).to(dev)
    before = launch_counts()["gather_rows"]
    syms, total_cfo, found = sync.extract_frames_batch(CFG, x, trig, cfo, 8)
    assert launch_counts()["gather_rows"] == before + 2
    with plain_kernels():
        p_syms, p_cfo, p_found = sync.extract_frames_batch(CFG, x, trig, cfo, 8)
    assert torch.equal(found, p_found) and torch.equal(total_cfo, p_cfo)
    torch.testing.assert_close(syms, p_syms, rtol=0, atol=gather_cuda.ROT_ATOL * float(x.abs().max()))


def test_entry_point_refuses_a_capture_off_its_device(dev):
    model = StreamingRx(CFG, SPEC, 2**13, 4, max_frames_per_block=4)  # no device: the card
    assert {b.device.type for b in model.buffers()} == {"cuda"}
    with pytest.raises(RuntimeError, match="device"):
        model(torch.zeros(4 * 2**13 + 4096, dtype=torch.complex64))


def test_streaming_rx_kernel_path_matches_plain_path(dev):
    """A small bench capture through StreamingRx: every frame decodes, the
    kernels ran, and the plain versions on the card give the same frames."""
    frame, payload, halo = capture.load_bench_frame()
    cap, n_frames = capture.build_capture(frame, 4 * 2**13, halo=halo)
    model = StreamingRx(CFG, SPEC, 2**13, 4, max_frames_per_block=4, device=dev)
    x = torch.from_numpy(cap).to(dev)
    before = launch_counts()["viterbi_decode"]
    res = model(x)
    assert launch_counts()["viterbi_decode"] == before + 2  # the SIG field, the payload
    assert int(res.valid.sum()) == int(res.crc_ok.sum()) == n_frames
    assert (res.payload[res.valid].cpu().numpy() == payload).all()
    with plain_kernels():
        plain = model(x)
    for f in ("valid", "start", "crc_ok", "sig_ok", "payload"):
        assert torch.equal(getattr(res, f), getattr(plain, f)), f


@pytest.mark.parametrize("variant", shuffle_pieces.VARIANTS)
def test_shuffle_pieces_kernel_matches_plain(dev, variant):
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (64, 200)).astype(np.float32)).to(dev)
    # 99 steps: odd and not a multiple of roll8's period, so a wrong
    # permutation does not end where the right one does
    state_k, sum_k = shuffle_pieces.shuffle_pieces(x, variant, 99)
    state_p, sum_p = shuffle_pieces.shuffle_pieces_plain(x, variant, 99)
    assert torch.equal(state_k, state_p) and torch.equal(sum_k, sum_p)


@pytest.mark.parametrize("variant", gather_pieces.VARIANTS)
def test_gather_pieces_kernel_matches_plain(dev, variant):
    rng = np.random.default_rng(6)
    n = 20_000
    x = torch.from_numpy((rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)).to(dev)
    starts = torch.from_numpy(rng.integers(-500, n + 500, 333)).to(dev)
    for width in (300, 3328):
        assert torch.equal(gather_pieces.gather_pieces(x, starts, width, variant),
                           gather_pieces.gather_pieces_plain(x, starts, width, variant))


@pytest.mark.parametrize("variant,chunk_t", [(v, 32) for v in viterbi_pieces.VARIANTS]
                         + [("full", 16), ("full", 64)])
def test_viterbi_pieces_kernel_matches_plain(dev, variant, chunk_t):
    rng = np.random.default_rng(chunk_t)
    va, vb = (rng.normal(0, 1, (128, 150)).astype(np.float32) for _ in range(2))
    va[rng.random(va.shape) < 0.2] = 0.0
    va, vb = torch.from_numpy(va).to(dev), torch.from_numpy(vb).to(dev)
    got = viterbi_pieces.viterbi_pieces(va, vb, variant, chunk_t)
    want = viterbi_pieces.viterbi_pieces_plain(va, vb, variant, chunk_t)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# one column; one just above a multiple of the columns a block (4 half-plane,
# 8 quads); the script's shape at 864 and 863 steps (864 brings roll8 and
# concat back where they began)
@pytest.mark.parametrize("b,steps", [(1, 99), (201, 37), (3072, 864), (3072, 863)])
@pytest.mark.parametrize("variant", shuffle_pieces.VARIANTS)
def test_shuffle_pieces_kernel_shapes(dev, variant, b, steps):
    x = torch.from_numpy(np.random.default_rng(b).normal(0, 1, (64, b)).astype(np.float32)).to(dev)
    state_k, sum_k = shuffle_pieces.shuffle_pieces(x, variant, steps)
    state_p, sum_p = shuffle_pieces.shuffle_pieces_plain(x, variant, steps)
    assert torch.equal(state_k, state_p) and torch.equal(sum_k, sum_p)


def _pieces_values(t, b, dev, seed):
    rng = np.random.default_rng(seed)
    va, vb = (rng.normal(0, 1, (t, b)).astype(np.float32) for _ in range(2))
    va[rng.random(va.shape) < 0.2] = 0.0  # erasures: ties
    return torch.from_numpy(va).to(dev), torch.from_numpy(vb).to(dev)


# B = 1 and 145 (one frame past a multiple of the 8 frames a block); T = 80
# ends on a short stage; chunk_t 24 and 3 take the step counter, and 9 x 7
# values noacs's 4-byte path; the script's shape at every chunk_t
@pytest.mark.parametrize("t,b,chunk_t", [(96, 1, 32), (80, 145, 16), (72, 145, 24), (9, 7, 3),
                                         (864, 3072, 16), (864, 3072, 32), (896, 3072, 64)])
@pytest.mark.parametrize("variant", viterbi_pieces.VARIANTS)
def test_viterbi_pieces_kernel_shapes(dev, variant, t, b, chunk_t):
    va, vb = _pieces_values(t, b, dev, t + b + chunk_t)
    got = viterbi_pieces.viterbi_pieces(va, vb, variant, chunk_t)
    want = viterbi_pieces.viterbi_pieces_plain(va, vb, variant, chunk_t)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_dynamic_kernel_path_matches_plain_path(dev):
    """A small mixed capture from the pinned frames through
    StreamingRxDynamic: every placed frame decodes with its MCS, type and
    payload, the kernels ran, and the plain versions give the same frames."""
    frames = capture.load_mixed_frames()
    block_len, n_blocks, max_payload = 2**13, 4, 256
    cap, placed = capture.build_mixed_capture(
        [f.samples for f in frames], block_len * n_blocks,
        halo=frame_window_samples_dynamic(CFG, max_payload) + CFG.fft_len)
    model = StreamingRxDynamic(CFG, block_len, n_blocks, max_frames_per_block=4,
                               max_payload=max_payload, device=dev)
    x = torch.from_numpy(cap).to(dev)
    before = (launch_counts()["viterbi_decode"], launch_counts()["gather_rows"])
    res = model(x)
    assert launch_counts()["viterbi_decode"] == before[0] + 2
    assert launch_counts()["gather_rows"] > before[1]
    valid = res.valid.cpu().numpy()
    assert int(valid.sum()) == int(res.crc_ok.sum()) == len(placed)
    slots = np.nonzero(valid)[0][np.argsort(res.start.cpu().numpy()[valid])]
    for slot, (_, k) in zip(slots, placed):
        f = frames[k]
        assert int(res.mcs[slot]) == f.mcs and int(res.packet_type_bit[slot]) == f.packet_type_bit
        assert (res.payload[slot, : len(f.payload)].cpu().numpy() == f.payload).all()
        assert bool(res.chan_est_ok[slot]) == (f.packet_type_bit == 0)
    with plain_kernels():
        plain = model(x)
    for f in ("valid", "start", "crc_ok", "sig_ok", "mcs", "packet_type_bit", "payload_len",
              "payload", "chan_est_ok"):
        assert torch.equal(getattr(res, f), getattr(plain, f)), f


# ------------------------------------------------------------ the sc16 wire


@pytest.mark.parametrize("n,fft_len,cp_len,full_scale", [
    (2 * 512 * 128, 64, 16, 1.0), (3 * 4096 + 77, 64, 16, 0.37), (200, 64, 16, 1.0),
    (40_000, 128, 32, 4.0)], ids=["two-chunks", "off-multiple", "below-margin", "mpd320"])
def test_detect_kernel_on_int16_matches_plain(dev, n, fft_len, cp_len, full_scale):
    """K2 loading the int16 stream: one launch, triggers and ``a`` exactly
    equal to the plain version's and to the kernel's on the dequantized
    stream."""
    rng = np.random.default_rng(n)
    x = (rng.normal(0, 0.02, n) + 1j * rng.normal(0, 0.02, n)).astype(np.complex64)
    block = 0.2 * (rng.normal(0, 1, fft_len // 4) + 1j * rng.normal(0, 1, fft_len // 4))
    for pos in (60, n // 2 - 200, n - 700):
        if 0 <= pos < n:
            x[pos : pos + 50 * len(block)] = np.tile(block, 50)[: n - pos]
    q = torch.from_numpy(quantize_sc16(x * full_scale, full_scale)).to(dev)
    dq = wire.dq_scale(full_scale)
    kw = _detect_kw(fft_len, cp_len)
    before = launch_counts()["detect_front_end"]
    got = detect_cuda.detect_front_end(q, dq=dq, **kw)
    assert launch_counts()["detect_front_end"] == before + 1
    want = detect_cuda.detect_front_end_plain(q, dq=dq, **kw)
    on_float = detect_cuda.detect_front_end(wire.dequantize(q, dq), **kw)
    if n >= 20_000:
        assert int(want[2].sum()) >= 2
    for g, w, f in zip(got, want, on_float):
        assert torch.equal(g, w) and torch.equal(g, f)


@pytest.mark.parametrize("index_type", [np.int64, np.int32])
@pytest.mark.parametrize("width", [1, 2, 5, 383, 1168, 3328, 7568])
def test_gather_kernel_on_int16_matches_plain(dev, width, index_type):
    """K3 loading the int16 stream (an unaligned one too): exactly the plain
    version's rows without ``rot``, within ROT_ATOL · max|x| with it, and
    exactly the kernel's own rows on the dequantized stream."""
    rng = np.random.default_rng(8)
    n = 50_001
    q = torch.from_numpy(rng.integers(-32767, 32768, (n, 2)).astype(np.int16)).to(dev)[1:]
    dq = wire.dq_scale(0.5)
    x = wire.dequantize(q, dq)
    starts = torch.from_numpy(rng.integers(-500, n + 500, 777).astype(index_type)).to(dev)
    omega = torch.from_numpy(rng.uniform(-0.02, 0.02, 777).astype(np.float32)).to(dev)
    n0 = torch.from_numpy(rng.integers(0, 320, 777).astype(index_type)).to(dev)
    atol = gather_cuda.ROT_ATOL * float(x.abs().max())
    for rot in (None, (omega, None), (omega, n0)):
        before = launch_counts()["gather_rows"]
        got = gather_cuda.gather_rows(q, starts, width, rot=rot, dq=dq)
        assert launch_counts()["gather_rows"] == before + 1
        want = gather_cuda.gather_rows_plain(q, starts, width, rot=rot, dq=dq)
        assert torch.equal(got, gather_cuda.gather_rows(x, starts, width, rot=rot))
        if rot is None:
            assert torch.equal(got, want)
        else:
            assert float((torch.view_as_real(got) - torch.view_as_real(want)).abs().max()) <= atol


def test_kernels_refuse_an_int16_stream_without_its_scale(dev):
    q = torch.zeros((4096, 2), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError, match="dq"):
        gather_cuda.gather_rows(q, torch.zeros(3, dtype=torch.int64, device=dev), 100)
    with pytest.raises(ValueError, match="dq"):
        detect_cuda.detect_front_end(q, **DETECT_KW)
    with pytest.raises(ValueError, match="dq"):
        detect_cuda.detect_front_end(torch.zeros(4096, dtype=torch.complex64, device=dev), dq=1.0,
                                     **DETECT_KW)


def _drain(streamer):
    return [{f: getattr(r, f).cpu() for f in r._fields} for r in streamer.process_available()]


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("wire_name", ["fc32", "sc16"])
def test_streamer_superblock_matches_the_plain_streamer(dev, wire_name, dynamic):
    """One superblock through the ring, the pinned staging buffer and the copy
    stream, each launch made from Python (jit=False): every bench frame
    decodes, the kernels ran (K2 once, K3 twice, K1 twice), and a streamer
    routed through the plain versions on the card gives the same result in
    every integer, flag and payload field."""
    frame, payload, _ = capture.load_bench_frame()
    block_len, n_blocks = 2**13, 4
    kw = dict(block_len=block_len, n_blocks=n_blocks, max_frames=4, max_payload=96, wire=wire_name,
              jit=False)
    spec = None if dynamic else SPEC
    s = BlockStreamer(CFG, spec, **kw)  # no device: the card
    cap, n_frames = capture.build_capture(frame, block_len * n_blocks, halo=s.halo)
    before = launch_counts()
    assert s.push(cap) == len(cap)
    (res,) = _drain(s)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in ("viterbi_decode", "detect_front_end",
                                              "gather_rows")} == {
        "viterbi_decode": 2, "detect_front_end": 1, "gather_rows": 2}
    assert s.stats.frames == s.stats.crc_ok == n_frames and s.stats.dropped_samples == 0
    assert (res["payload"][res["valid"]][:, : len(payload)].numpy() == payload).all()
    with plain_kernels():
        p = BlockStreamer(CFG, spec, device=dev, **kw)
        p.push(cap)
        (plain,) = _drain(p)
    for f in res:
        if res[f].is_floating_point() or res[f].is_complex():
            continue
        assert torch.equal(res[f], plain[f]), f
    torch.testing.assert_close(res["snr_db"][res["valid"]], plain["snr_db"][res["valid"]],
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "captured"])
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("wire_name", ["fc32", "sc16"])
def test_staging_buffers_are_not_overwritten_under_a_copy_in_flight(dev, wire_name, depth, jit):
    """Many small superblocks pushed at once and drained in one go, so that
    every staging buffer is popped into again while earlier uploads and calls
    (or the graph's static input, captured) are still queued: the decoded
    (start, payload) set must be that of one scan_rx over the whole capture."""
    frame, payload, _ = capture.load_bench_frame()
    block_len, n_super = 2**12, 24
    n = block_len * n_super
    s = BlockStreamer(CFG, SPEC, block_len=block_len, max_frames=4, pipeline_depth=depth,
                      wire=wire_name, ring_capacity=2 * n, jit=jit)
    cap, n_frames = capture.build_capture(frame, n, halo=s.halo)
    whole = cap
    if wire_name == "sc16":
        whole = wire.dequantize(torch.from_numpy(quantize_sc16(cap, 1.0)), wire.dq_scale()).numpy()
    oracle = StreamingRx(CFG, SPEC, block_len, n_super, max_frames_per_block=4)(
        torch.from_numpy(whole).to(dev))
    want = sorted((int(st), bytes(p)) for st, p, v in zip(
        oracle.start.cpu().numpy(), oracle.payload.cpu().numpy(), oracle.valid.cpu().numpy()) if v)
    assert len(want) == n_frames
    s.push(cap)
    results = _drain(s)
    assert len(results) == n_super
    got = sorted((k * s.span + int(st), bytes(p)) for k, r in enumerate(results) for st, p, v
                 in zip(r["start"].numpy(), r["payload"].numpy(), r["valid"].numpy()) if v)
    assert got == want
    assert s.stats.crc_ok == n_frames and s.stats.dropped_samples == 0


def test_streamer_without_a_device_argument_lies_on_the_card(dev):
    s = BlockStreamer(CFG, SPEC, block_len=2**12, wire="sc16")
    assert all(slot.host.is_pinned() and slot.dev.is_cuda for slot in s._slots)
    assert s._copy_stream is not None and s._copy_stream != torch.cuda.current_stream()


def _streamer_pair(dev, path, wire_name):
    """(jit=True streamer, jit=False streamer, capture of four superblocks):
    ``path`` static (the bench frame), dynamic (the bench frame, max_payload
    96) or mixed (the seven pinned mixed frames, max_payload 256)."""
    kw = dict(block_len=2**13, n_blocks=2, max_frames=4, wire=wire_name, device=dev,
              max_payload=256 if path == "mixed" else 96)
    spec = SPEC if path == "static" else None
    pair = [BlockStreamer(CFG, spec, jit=jit, **kw) for jit in (True, False)]
    n = 4 * pair[0].span
    if path == "mixed":
        cap, _ = capture.build_mixed_capture([f.samples for f in capture.load_mixed_frames()], n,
                                             halo=pair[0].halo)
    else:
        cap, _ = capture.build_capture(capture.load_bench_frame()[0], n, halo=pair[0].halo)
    return pair[0], pair[1], cap


@pytest.mark.parametrize("path", ["static", "dynamic", "mixed"])
@pytest.mark.parametrize("wire_name", ["fc32", "sc16"])
def test_captured_streamer_equals_eager(dev, path, wire_name):
    """The same pushes (the capture in two halves, then a flush) through
    BlockStreamer(jit=True), one CUDA graph replayed a superblock, and
    jit=False: every field of every superblock exactly equal, and the graph
    captured once (its kernels launched from Python only in the warm-up and
    the capture)."""
    captured, eager, cap = _streamer_pair(dev, path, wire_name)
    out = []
    for s in (captured, eager):
        half = len(cap) // 2
        res = []
        for part in (cap[:half], cap[half:]):
            assert s.push(part) == len(part)
            res += _drain(s)
        res += [{f: getattr(r, f).cpu() for f in r._fields} for r in s.flush()]
        out.append(res)
    assert len(out[0]) == len(out[1]) >= 5
    for k, (a, b) in enumerate(zip(*out)):
        for f in b:
            assert torch.equal(a[f], b[f]), (k, f)
    assert captured.stats == eager.stats and captured.stats.crc_ok > 0
    assert len(captured._rx._graphs) == 1


def test_a_kept_result_survives_later_replays(dev):
    """Superblock k kept by the caller, then two superblocks of zeros replayed
    through the same graph: the kept result still holds its frames."""
    captured, _, cap = _streamer_pair(dev, "static", "fc32")
    captured.push(cap[: captured.span + captured.halo + captured.left_hist])
    (kept,) = list(captured.process_available())
    snapshot = {f: getattr(kept, f).clone() for f in kept._fields}
    assert int(kept.crc_ok.sum()) > 0
    captured.push(np.zeros(2 * captured.span, np.complex64))
    later = list(captured.process_available())
    assert len(later) == 2 and int(later[-1].valid.sum()) == 0  # zeros from end to end
    for f, v in snapshot.items():
        assert torch.equal(getattr(kept, f), v), f


def test_a_host_sync_fails_the_capture_with_no_eager_fallback(dev):
    """A function with an ``.item()`` warms up, then its capture raises a
    RuntimeError that names it; no result comes back and a second call
    raises again (nothing ran eagerly in the graph's place)."""
    from jrc_tpu_torch.utils import graph

    calls = []

    def synced(x):
        calls.append(1)
        return x * x.sum().item()

    f = graph.jit(synced, name="synced")
    x = torch.arange(8.0, device=dev)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="synced: CUDA graph capture failed"):
            f(x)
    assert len(calls) == 4 and not f._graphs  # two warm-ups, two failed captures
    torch.cuda.synchronize()
    assert torch.equal(graph.jit(lambda v: v * 2)(x), x * 2)  # the card still works


def test_flat_rx_dynamic_makes_no_host_sync(dev):
    """The SIG-driven flat pass on the mixed capture under
    set_sync_debug_mode("error"): no call that waits for the card."""
    from jrc_tpu_torch.models import streaming as st

    n_blocks, block_len = 2, 2**13
    halo = st.frame_window_samples_dynamic(CFG, 256) + CFG.fft_len
    cap, placed = capture.build_mixed_capture(
        [f.samples for f in capture.load_mixed_frames()], n_blocks * block_len, halo=halo)
    left = st.left_history_samples(CFG)
    xp = torch.cat([torch.zeros(left, dtype=torch.complex64), torch.from_numpy(cap)]).to(dev)
    tab = tables.from_numpy_dynamic(CFG, 256, dev)
    run = lambda: st.flat_rx_dynamic(CFG, tab, xp, block_len, n_blocks, left,  # noqa: E731
                                     max_frames=4, max_payload=256)
    run()  # the kernel library and PyTorch's plans built outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(res.valid.sum()) == len(placed) and int(res.crc_ok.sum()) > 0


def test_captured_link_curve_equals_eager(dev):
    """One curve (QPSK-3/4 at three SNRs, 8 frames of seeded noise a point)
    through one captured graph and through eager launches: every frame's bit
    errors and CRC flag equal, and the LinkPoints."""
    from jrc_tpu_torch.models import comm_link, evaluation
    from jrc_tpu_torch.ops import channel

    spec, tab, payload = _sim_frame(MCS.QPSK_3_4, dev)
    gen = torch.Generator().manual_seed(11)
    noise = [channel.normal_pair((8, comm_link.loopback_samples(CFG, spec)), generator=gen)
             for _ in range(3)]
    pts = {}
    curves = {jit: evaluation.link_curve(CFG, spec, tab, payload, [4.0, 7.0, 10.0], n_frames=8,
                                         noise=noise, points=pts.setdefault(jit, []), jit=jit)
              for jit in (True, False)}
    assert curves[True] == curves[False]
    for a, b in zip(pts[True], pts[False]):
        assert torch.equal(a.bit_errors, b.bit_errors) and torch.equal(a.crc_ok, b.crc_ok)
    assert len({id(r.crc_ok) for r in pts[True]}) == 3  # each point its own fresh tensors


def test_jrc_trx_reproduces_the_pinned_dwells_on_the_card(dev):
    """JRCTrx on the card over the dwells jrc_tpu pinned, with their draws:
    exact fields equal, floats within capture.jrc_mismatches' tolerances."""
    from jrc_tpu_torch.models import jrc_trx

    trx = jrc_trx.JRCTrx(CFG)
    assert trx.device.type == "cuda"
    state = trx.init_state()
    for i, dw in enumerate(capture.pinned_jrc_dwells()):
        spec, payload, targets, draws, opts = capture.pinned_step_args(dw, dev)
        r = trx(state, spec, payload, targets, draws=draws, **opts)
        assert capture.jrc_mismatches(capture.step_record(r), capture.jrc_record(dw.want)) == [], i
        state = r.state


def test_jrc_step_kernels_match_the_plain_path(dev):
    """One jrc_step through K1-K3 and through their plain versions on the
    card, same state and draws: the same decoded frame, trigger and radar
    estimate."""
    from jrc_tpu_torch.models import jrc_trx

    trx = jrc_trx.JRCTrx(CFG)
    dw = capture.pinned_jrc_dwells()[0]
    spec, payload, targets, draws, opts = capture.pinned_step_args(dw, dev)
    got = trx(trx.init_state(), spec, payload, targets, draws=draws, **opts)
    with plain_kernels():
        want = trx(trx.init_state(), spec, payload, targets, draws=draws, **opts)
    for a, b in ((got.comm.decoded.payload, want.comm.decoded.payload),
                 (got.comm.decoded.crc_ok, want.comm.decoded.crc_ok),
                 (got.comm.detection.start, want.comm.detection.start),
                 (got.radar_est.range_idx, want.radar_est.range_idx),
                 (got.radar_est.angle_idx, want.radar_est.angle_idx)):
        assert torch.equal(a, b)


def _sim_frame(mcs, dev):
    from jrc_tpu_torch.ops.encoder import make_payload

    spec = FrameSpec(mcs, payload_bytes=64, packet_type=PacketType.DATA)
    payload = torch.from_numpy(make_payload(spec, b"\x02sim")).to(dev)
    return spec, tables.from_numpy(CFG, spec, dev), payload


def test_link_point_kernels_match_the_plain_path(dev):
    """One link_curve point (QPSK-3/4, 9 dB, 16 frames) through K1-K3 and
    through their plain versions on the card, same noise: the same bit
    errors and CRC flags; K1 2, K2 1, K3 2 launches a point."""
    from jrc_tpu_torch.models import evaluation

    spec, tab, payload = _sim_frame(MCS.QPSK_3_4, dev)
    clean = evaluation.clean_waveform(CFG, spec, tab, payload)
    nv, z = evaluation.point_inputs(clean, 9.0, 16, 4)
    before = launch_counts()
    got = evaluation.link_point(CFG, spec, tab, payload, clean, nv, z)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in ("viterbi_decode", "detect_front_end",
                                              "gather_rows")} == {
        "viterbi_decode": 2, "detect_front_end": 1, "gather_rows": 2}
    with plain_kernels():
        want = evaluation.link_point(CFG, spec, tab, payload, clean, nv, z)
    assert torch.equal(got.bit_errors, want.bit_errors) and torch.equal(got.crc_ok, want.crc_ok)


@pytest.mark.parametrize("mcs,snr_db", [(MCS.BPSK_1_2, 1.0), (MCS.QAM16_3_4, 11.5)])
def test_link_curve_on_the_card_equals_the_cpu(dev, mcs, snr_db):
    """The same CPU-drawn noise through link_curve on the card and on the CPU:
    every frame's bit errors and CRC flag equal (chip_smoke's gate (a))."""
    from jrc_tpu_torch.models import comm_link, evaluation
    from jrc_tpu_torch.ops import channel

    spec, tab, payload = _sim_frame(mcs, dev)
    noise = [channel.normal_pair((8, comm_link.loopback_samples(CFG, spec)),
                                 generator=torch.Generator().manual_seed(7))]
    card, cpu = [], []
    evaluation.link_curve(CFG, spec, tab, payload, [snr_db], n_frames=8, noise=noise, points=card)
    _, tab_cpu, payload_cpu = _sim_frame(mcs, "cpu")
    evaluation.link_curve(CFG, spec, tab_cpu, payload_cpu, [snr_db], n_frames=8, noise=noise,
                          points=cpu)
    assert torch.equal(card[0].bit_errors.cpu(), cpu[0].bit_errors)
    assert torch.equal(card[0].crc_ok.cpu(), cpu[0].crc_ok)


def test_radar_extras_on_the_card_equal_the_cpu(dev):
    """range_angle_estimate_multi, cfar_detect, range_doppler_map /
    range_doppler_estimate and fft_peak_detect on the card against the CPU on
    the same input: indices and flags equal, floats within 1e-5 · max."""
    from jrc_tpu_torch.ops import radar

    rng = np.random.default_rng(3)
    m = (rng.normal(size=(512, 128)) + 1j * rng.normal(size=(512, 128))).astype(np.complex64)
    m[100, 40] += 300.0
    m[400, 90] += 80.0 - 20j
    rb = torch.from_numpy(np.linspace(0, 76.8, 512).astype(np.float32))
    ab = torch.from_numpy(np.asarray(CFG.angle_axis(16), np.float32))
    mt = torch.from_numpy(m)
    got = radar.range_angle_estimate_multi(mt.to(dev), rb.to(dev), ab.to(dev))
    want = radar.range_angle_estimate_multi(mt, rb, ab)
    for f in ("detected", "range_idx", "angle_idx", "range_m", "angle_deg"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    torch.testing.assert_close(got.power.cpu(), want.power, rtol=1e-5, atol=0)
    p = (mt.abs() ** 2).to(torch.float32)
    cg, cw = radar.cfar_detect(p.to(dev), pfa=1e-6), radar.cfar_detect(p, pfa=1e-6)
    near = (p - cw.threshold).abs() <= 1e-4 * cw.threshold
    assert not ((cg.detections.cpu() != cw.detections) & ~near).any()
    torch.testing.assert_close(cg.noise.cpu(), cw.noise, rtol=1e-5, atol=1e-5 * float(p.max()))
    hist = torch.from_numpy((rng.normal(size=(16, 8, 64)) + 1j * rng.normal(size=(16, 8, 64)))
                            .astype(np.complex64))
    rd_g, rd_w = radar.range_doppler_map(hist.to(dev)), radar.range_doppler_map(hist)
    torch.testing.assert_close(rd_g.cpu(), rd_w, rtol=0, atol=1e-5 * float(rd_w.max()))
    vb = torch.from_numpy(radar.velocity_axis(16, 1.7e-5, CFG.center_freq))
    eg = radar.range_doppler_estimate(rd_w.to(dev), rb.to(dev), vb.to(dev))
    ew = radar.range_doppler_estimate(rd_w, rb, vb)
    for f in ("range_m", "velocity_mps", "detected", "blind_zone_mps", "power"):
        assert torch.equal(getattr(eg, f).cpu(), getattr(ew, f)), f
    spec = torch.fft.fft(torch.from_numpy(m[:4]))
    pg = radar.fft_peak_detect(spec.to(dev), 1e6)
    pw = radar.fft_peak_detect(spec, 1e6)
    assert torch.equal(pg.freq.cpu(), pw.freq) and torch.equal(pg.detected.cpu(), pw.detected)


# ------------------------------------------- the per-block RX and the mesh


def _block_capture(n_blocks: int, block_len: int):
    frame, payload, halo = capture.load_bench_frame()
    cap, n_frames = capture.build_capture(frame, n_blocks * block_len, halo=halo)
    return cap, n_frames, payload


@pytest.mark.parametrize("batched", [True, False], ids=["windowed", "sequential"])
@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_block_paths_kernel_matches_plain(dev, dynamic, batched):
    """The windowed and sequential scans (block_len 8128, off every multiple
    of 128) on the card: every bench frame decodes with the pinned payload,
    K1-K3 ran (K2 once a block), and the plain versions give the same
    frames."""
    block_len, n_blocks = 2**13 - 64, 4
    cap, n_frames, payload = _block_capture(n_blocks, block_len)
    kw = dict(max_frames_per_block=4, batched=batched, device=dev)
    model = (StreamingRxDynamic(CFG, block_len, n_blocks, max_payload=96, **kw) if dynamic
             else StreamingRx(CFG, SPEC, block_len, n_blocks, **kw))
    x = torch.from_numpy(cap).to(dev)
    before = launch_counts()
    res = model(x)
    after = launch_counts()
    assert after["detect_front_end"] - before["detect_front_end"] == n_blocks
    assert after["gather_rows"] > before["gather_rows"]
    assert after["viterbi_decode"] > before["viterbi_decode"]
    assert int(res.valid.sum()) == int(res.crc_ok.sum()) == n_frames
    assert (res.payload[res.valid][:, :64].cpu().numpy() == payload).all()
    with plain_kernels():
        plain = model(x)
    for f in res._fields:
        if f not in ("snr_db", "snr_data_db", "chan_est"):
            assert torch.equal(getattr(res, f), getattr(plain, f)), f


def test_rx_block_batch_kernel_matches_plain(dev):
    from jrc_tpu_torch.models.streaming import rx_block

    cap, _, _ = _block_capture(2, 2**13)
    windows = torch.from_numpy(np.stack([cap[: 2**13 + 2000], cap[2**13 - 2000 : 2**14]])).to(dev)
    tab = tables.from_numpy(CFG, SPEC, dev)
    res = rx_block(CFG, SPEC, tab, windows, 2**13 - 2000, max_frames=4)
    with plain_kernels():
        plain = rx_block(CFG, SPEC, tab, windows, 2**13 - 2000, max_frames=4)
    assert res.valid.shape == (2, 4) and int(res.crc_ok.sum()) > 0
    for f in ("valid", "start", "crc_ok", "payload"):
        assert torch.equal(getattr(res, f), getattr(plain, f)), f


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_sharded_world_of_one_on_the_card(dev, backend):
    """One rank on the card (NCCL, or gloo with the decoding on the card):
    sharded_rx, sharded_rx_dynamic and batched_rx equal scan_rx and
    rx_block on the same samples."""
    from jrc_tpu_torch.models.streaming import frame_window_samples, rx_block, scan_rx
    from jrc_tpu_torch.parallel import batch, mesh, streaming as pstream

    cap, n_frames, _ = _block_capture(4, 2**13)
    n = 4 * 2**13
    halo = frame_window_samples(CFG, SPEC) + CFG.fft_len
    tab = tables.from_numpy(CFG, SPEC, dev)
    want = scan_rx(CFG, SPEC, tab, torch.from_numpy(cap).to(dev), n, 1, max_frames_per_block=64)
    with mesh.local_group(backend):
        tm = mesh.time_mesh()
        block = pstream.local_block(tm, cap[:n])
        assert block.device.type == "cuda"
        res = pstream.sharded_rx(CFG, SPEC, tm, block, max_frames_per_block=64)
        for f in ("valid", "start", "crc_ok", "payload"):
            assert torch.equal(getattr(res, f)[0], getattr(want, f)), f
        assert int(res.n_frames) == int(res.n_crc_ok) == n_frames
        dyn = pstream.sharded_rx_dynamic(CFG, tm, block, max_frames_per_block=64, max_payload=96)
        assert int(dyn.n_crc_ok) == n_frames
        caps = np.stack([cap[b * 2**13 : (b + 1) * 2**13 + halo] for b in range(2)])
        counts = batch.batched_rx(mesh.batch_mesh(), CFG, SPEC, caps, max_frames=8)
        one = rx_block(CFG, SPEC, tab, torch.from_numpy(caps).to(dev), 2**13, max_frames=8)
        assert counts.device.type == "cuda"
        assert torch.equal(counts[:, 1], one.crc_ok.sum(-1).to(torch.float32))


@pytest.mark.parametrize("local_rank", ["0", "1", "9"])
def test_compute_device_under_torchrun_lies_on_a_card_of_the_host(dev, monkeypatch, local_rank):
    """torchrun sets LOCAL_RANK for every process; more processes than cards
    share them, so the default device is a valid ordinal."""
    from jrc_tpu_torch.parallel.mesh import compute_device

    monkeypatch.setenv("LOCAL_RANK", local_rank)
    d = compute_device()
    assert d == torch.device("cuda", int(local_rank) % torch.cuda.device_count())
    assert torch.ones(2, device=d).sum().item() == 2


# ------------------------------------------ the program's tracing (utils/profiling)


def _count_kernels(fn, name: str) -> int:
    """Device kernels whose name holds ``name`` in a device-only profiler
    trace of ``fn()``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(name in e.name for e in prof.events() if e.device_type.name == "CUDA")


def _stage_clock_checks(entry: str) -> None:
    """The stage clock of ``entry`` against the program's event-timed graph
    replays of the same calls (``profiling.device_ms``, which
    ``device_idle_pct`` reads): the stages' medians sum to the median
    replay within 5%, either way."""
    from jrc_tpu_torch.utils import profiling

    stages = profiling.stage_ms(entry)
    assert list(stages) == list(profiling.STAGES[entry][1:])
    call_ms = profiling.median(profiling.device_ms(entry))
    assert call_ms is not None and abs(sum(stages.values()) / call_ms - 1) < 0.05, (
        stages, sum(stages.values()), call_ms)


def test_the_rx_stages_hold_the_captured_call(dev):
    """The captured SIG-driven streamer at the live receiver's geometry
    (2^16-sample blocks, 32 slots, 3100-B envelope) over the pinned mixed
    frames: the seven stamps of each call are seven kernels of its graph,
    the stage clock agrees with the call's events (``_stage_clock_checks``),
    and frames and slots are counted."""
    from jrc_tpu_torch.utils import profiling

    profiling.reset()
    frames = [f.samples for f in capture.load_mixed_frames()]
    rng = np.random.default_rng(0)
    cap = (rng.normal(0, 1e-4, (1 << 19, 2)) @ [1, 1j]).astype(np.complex64)
    pos, k = 700, 0
    while pos + len(frames[k % len(frames)]) < len(cap):
        f = frames[k % len(frames)]
        cap[pos : pos + len(f)] += f
        pos, k = pos + len(f) + 2111, k + 1
    s = BlockStreamer(CFG, None, block_len=1 << 16, max_frames=32, max_payload=3100,
                      pipeline_depth=2, jit=True)
    calls = []

    def run(n):
        while len(calls) < n:
            for i in range(0, len(cap), 1 << 15):
                s.push(cap[i : i + (1 << 15)])
                calls.extend(s.process_available())
    run(8)
    replays = s._rx.replays
    stamps = _count_kernels(lambda: run(len(calls) + 4), "stamp_kernel")
    assert stamps == 7 * (s._rx.replays - replays), stamps
    run(len(calls) + 80)
    torch.cuda.synchronize()
    s.push(cap[: 1 << 15])  # harvests the event pairs of the calls before
    calls.extend(s.process_available())
    assert s.stats.calls == len(calls) and profiling.tracked("rx") is s.stats
    assert s.stats.slots_decoded == 32 * len(calls) and s.stats.frames > 8 * len(calls)
    assert s._rx.captures == 1 and s._rx.replays == len(calls)
    assert len(profiling.device_ms("rx")) >= len(calls) // profiling.DeviceClock.EVERY - 1
    _stage_clock_checks("rx")


def test_the_dwell_stages_hold_the_captured_step(dev):
    """The captured JRC dwell: five stamps a dwell, and the stage clock
    agrees with the step's events (``_stage_clock_checks``)."""
    from jrc_tpu_torch.utils import profiling

    profiling.reset()
    _, captured, step, spec, payload, scene = _jrc_pair(dev)
    box = {"state": captured.init_state()}

    def dwells(n):
        for _ in range(n):
            box["state"] = step(box["state"], spec, payload, scene, comm_noise_var=1e-4).state

    dwells(2)
    assert _count_kernels(lambda: dwells(3), "stamp_kernel") == 15
    dwells(80)
    torch.cuda.synchronize()
    dwells(1)  # harvests the event pairs of the dwells before
    assert (step.captures, step.replays) == (1, 86)
    _stage_clock_checks("dwell")


def test_a_second_call_of_one_signature_captures_nothing(dev):
    from jrc_tpu_torch.utils import graph

    f = graph.jit(lambda v: v * 2 + 1, name="affine")
    x = torch.arange(8.0, device=dev)
    for _ in range(3):
        assert torch.equal(f(x), x * 2 + 1)
    assert (f.replays, f.captures) == (3, 1)
    f(torch.arange(4.0, device=dev))  # a new signature: one capture more
    assert (f.replays, f.captures) == (4, 2)


def test_a_host_span_holds_its_kernel_on_the_merged_clock(dev, tmp_path):
    """A span around a launch and a synchronize, recorded, merged into a
    device-only profiler trace: the kernel's interval lies inside the span
    on the merged clock, and the idle gap before the kernel is put down to it."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from jrc_tpu_torch.utils import profiling

    a = torch.randn(4096, 4096, device=dev)
    (a @ a).sum().item()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, profiling.recording():
        with profiling.span("host"):
            torch.cuda._sleep(1000)
            time.sleep(0.002)  # a host step: the device idles
            with profiling.span("matmul"):
                b = a @ a
                torch.cuda.synchronize()
    raw = tmp_path / "device.json"
    prof.export_chrome_trace(str(raw))
    trace = json.loads(profiling.export(tmp_path / "merged.json", raw).read_text())
    (sp,) = [e for e in trace["traceEvents"] if e.get("name") == "matmul"]
    k = max((e for e in trace["traceEvents"] if e.get("cat") == "kernel"), key=lambda e: e["dur"])
    assert sp["ts"] <= k["ts"] and k["ts"] + k["dur"] <= sp["ts"] + sp["dur"], (sp, k)
    gaps = profiling.idle_gaps(raw)
    assert gaps[0][2] == "host" and gaps[0][1] >= 1e6, gaps[:3]
    del b


def test_the_stamp_kernel_writes_the_plain_layout(dev, monkeypatch):
    """Stamps launched eagerly on the card: complete rows in call order,
    stages in order, the ring wrapping after ROWS calls, a stamp before any
    call writing nothing."""
    from jrc_tpu_torch.utils import profiling

    profiling.reset()
    monkeypatch.setattr(profiling, "ROWS", 4)
    x = torch.zeros(1, device=dev)
    profiling.stamp("dwell", "radar", x)
    for _ in range(6):
        for st in profiling.STAGES["dwell"]:
            profiling.stamp("dwell", st, x)
    profiling.stamp("dwell", "start", x)
    rows = profiling.stage_rows("dwell")
    assert [r[0] for r in rows] == [4, 5, 6]  # call 7 under way overwrote call 3's row
    for r in rows:
        assert r[1:] == sorted(r[1:]) and r[1] > 0
    profiling.reset()


@pytest.mark.parametrize("sequence", ["entry", "sounding"])
@pytest.mark.parametrize("c", capture.ANTENNA_CONFIGS, ids=lambda c: "x".join(map(str, c)))
def test_jrc_step_at_antenna_config_on_the_card_equals_the_cpu(dev, c, sequence):
    """A dwell sequence at each antenna configuration beside the default
    (the entry dwell three times; NDP sounding, then a steered DATA frame
    with radar streams): the card's records equal the CPU's (exact fields;
    floats within ``capture.jrc_mismatches``' tolerances), K1-K3 launched."""
    from jrc_tpu_torch.models import jrc_trx

    cfg = capture.antenna_config(*c)
    dwells = {"entry": capture.ENTRY_DWELLS, "sounding": capture.SOUNDING_DWELLS}[sequence]
    draws = capture.config_draws(cfg, dwells, np.random.default_rng(sum(c)))
    want = capture.config_dwells(jrc_trx.JRCTrx(cfg, device="cpu"), dwells, *draws)
    before = launch_counts()
    got = capture.config_dwells(jrc_trx.JRCTrx(cfg, device=dev), dwells, *draws)
    after = launch_counts()
    for i, (g, w) in enumerate(zip(got, want)):
        assert capture.jrc_mismatches(g, w) == [], i
    assert {k for k in after if after[k] > before[k]} == {
        "viterbi_decode", "detect_front_end", "gather_rows"}


@pytest.mark.parametrize("c", [(1, 1, 1), (2, 1, 2)], ids=["1x1x1", "2x1x2"])
def test_scan_rx_at_n_ltf_on_the_card(dev, c):
    """scan_rx at n_ltf 1 and 2 on a capture of frames the port encodes
    there: every frame CRC-clean with its payload, the plain path equal."""
    from jrc_tpu_torch.models.streaming import frame_window_samples

    cfg = capture.antenna_config(*c)
    frame, payload = capture.config_frame(cfg, SPEC, b"card")
    cap, n_frames = capture.build_capture(
        frame, 2**13 * 8, halo=frame_window_samples(cfg, SPEC) + cfg.fft_len)
    model = StreamingRx(cfg, SPEC, 2**13, 8, max_frames_per_block=4, device=dev)
    x = torch.from_numpy(cap).to(dev)
    res = model(x)
    with plain_kernels():
        res_plain = model(x)
    assert int(res.valid.sum()) == int(res.crc_ok.sum()) == n_frames
    assert (res.payload.cpu().numpy()[res.valid.cpu().numpy()] == payload).all()
    for f in ("valid", "start", "crc_ok", "payload"):
        assert torch.equal(getattr(res, f), getattr(res_plain, f)), f


def test_viterbi_decode_chunked_on_the_card(dev):
    """The chunk-parallel decoder on the card equals itself on the CPU, and
    K1 but where two paths cost exactly the same."""
    from jrc_tpu_torch.ops import coding

    v = _soft_values(256, 576, dev)
    got = viterbi.viterbi_decode_chunked(v)
    assert torch.equal(got.cpu(), viterbi.viterbi_decode_chunked(v.cpu()))
    k1 = viterbi_cuda.viterbi_decode(v, None)

    def cost(bits):
        c = coding.conv_encode(bits).to(torch.float64)
        return -(v.to(torch.float64) * (2 * c - 1)).sum(-1)

    assert float((cost(got) - cost(k1)).abs().max()) <= 1e-6


def test_interleave_on_the_card_equals_the_cpu(dev):
    from jrc_tpu_torch.config import MCSParams
    from jrc_tpu_torch.ops import coding

    for mcs in MCS:
        p = MCSParams(mcs)
        bits = torch.from_numpy(np.random.default_rng(int(mcs)).integers(
            0, 2, (3, 2 * p.n_cbps)).astype(np.uint8))
        for reverse in (False, True):
            got = coding.interleave(bits.to(dev), p.n_cbps, p.n_bpsc, reverse=reverse)
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), coding.interleave(bits, p.n_cbps, p.n_bpsc,
                                                            reverse=reverse))


# ------------------------------------ the compile sites captured (graph.jit)


def _leaves(tree) -> list:
    from jrc_tpu_torch.utils import graph

    return graph.signature((tree,), {})[1]


def _jrc_pair(dev, seed=3):
    """Two JRCTrx from one seed, the second stepped through graph.jit, at the
    operating point of chip_smoke.py's jrc phase (a DATA frame of 80 B, a
    target at 12 m, 5 m/s, 25°, comm noise variance 1e-4, the noise drawn
    from the module's generator)."""
    from jrc_tpu_torch.models import jrc_trx
    from jrc_tpu_torch.ops import channel
    from jrc_tpu_torch.ops.encoder import make_payload
    from jrc_tpu_torch.utils import graph

    eager, captured = (jrc_trx.JRCTrx(CFG, seed=seed) for _ in range(2))
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=80, packet_type=PacketType.DATA)
    payload = torch.from_numpy(make_payload(spec, bytes([2]) + b"bench jrc")).to(dev)
    scene = channel.Targets((12.0,), (5.0,), (25.0,), (10.0,)).on(dev)
    step = graph.jit(captured, generators=(captured.generator,))
    return eager, captured, step, spec, payload, scene


def test_captured_jrc_step_equals_eager(dev):
    """Four dwells of one seed with the state carried, eager and through one
    captured graph (the generator restored after the warm-up): every field of
    every dwell equal, bit for bit; one graph; the generators end equal; a
    result kept from dwell 1 is unchanged after the later replays."""
    eager, captured, step, spec, payload, scene = _jrc_pair(dev)
    s_e, s_c = eager.init_state(), captured.init_state()
    kept = None
    for d in range(4):
        r_e = eager(s_e, spec, payload, scene, comm_noise_var=1e-4)
        r_c = step(s_c, spec, payload, scene, comm_noise_var=1e-4)
        for k, (a, b) in enumerate(zip(_leaves(r_c), _leaves(r_e))):
            assert torch.equal(a, b), (d, k)
        if d == 1:
            kept, snapshot = r_c, [t.clone() for t in _leaves(r_c)]
        s_e, s_c = r_e.state, r_c.state
    assert bool(r_c.radar_est.detected) and bool(r_c.comm.decoded.crc_ok)
    assert len(step._graphs) == 1
    assert torch.equal(eager.generator.get_state(), captured.generator.get_state())
    assert all(torch.equal(a, b) for a, b in zip(_leaves(kept), snapshot))


def test_captured_jrc_step_makes_no_host_sync(dev):
    """A replay of the captured step under set_sync_debug_mode("error")."""
    _, captured, step, spec, payload, scene = _jrc_pair(dev)
    state = step(captured.init_state(), spec, payload, scene, comm_noise_var=1e-4).state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r = step(state, spec, payload, scene, comm_noise_var=1e-4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(r.comm.decoded.crc_ok)


def test_tuple_targets_in_a_capture_raise(dev):
    """A scene of host values would be uploaded from a temporary pinned
    buffer inside the capture, which every replay would read again after it
    is freed: the capture raises naming the function and the remedy."""
    from jrc_tpu_torch.ops import channel

    _, captured, step, spec, payload, _ = _jrc_pair(dev)
    host = channel.Targets((12.0,), (5.0,), (25.0,), (10.0,))
    with pytest.raises(RuntimeError, match=r"JRCTrx: CUDA graph capture failed.*Targets\.on"):
        step(captured.init_state(), spec, payload, host, comm_noise_var=1e-4)
    assert not step._graphs


def test_captured_radar_frame_equals_eager(dev):
    """Four radar_frame dwells with a random target phase and thermal noise
    drawn from one seed: captured equal to eager in every field."""
    from functools import partial

    from jrc_tpu_torch.models import radar_chain
    from jrc_tpu_torch.ops import channel
    from jrc_tpu_torch.ops.encoder import make_payload
    from jrc_tpu_torch.utils import graph

    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=80, packet_type=PacketType.DATA)
    payload = torch.from_numpy(make_payload(spec, bytes([2]) + b"bench jrc")).to(dev)
    tab, rtab = tables.from_numpy(CFG, spec, dev), tables.radar_from_numpy(CFG, dev)
    scene = channel.Targets((12.0, 5.0), (5.0, 0.0), (25.0, -20.0), (10.0, 10.0)).on(dev)
    gens = [torch.Generator(device=dev).manual_seed(5) for _ in range(2)]
    kw = dict(random_phase=True, noise_var=channel.thermal_noise_var(CFG.sample_rate))
    eager = partial(radar_chain.radar_frame, CFG, spec, tab, rtab, generator=gens[0], **kw)
    step = graph.jit(partial(radar_chain.radar_frame, CFG, spec, tab, rtab, generator=gens[1],
                             **kw), generators=(gens[1],))
    for d in range(4):
        got, want = step(payload, scene), eager(payload, scene)
        for k, (a, b) in enumerate(zip(_leaves(got), _leaves(want))):
            assert torch.equal(a, b), (d, k)
    assert bool(got.estimate.detected) and len(step._graphs) == 1


def test_captured_sharded_world_of_one_equals_eager(dev):
    """A world of one on NCCL: sharded_rx, sharded_rx_dynamic, batched_rx and
    batched_range_angle_maps captured inside (one graph each on the mesh)
    equal their eager runs (graph.eager) in every field, twice."""
    from jrc_tpu_torch.models.streaming import frame_window_samples
    from jrc_tpu_torch.parallel import batch, mesh, streaming as pstream
    from jrc_tpu_torch.utils import graph

    cap, n_frames, _ = _block_capture(4, 2**13)
    n = 4 * 2**13
    halo = frame_window_samples(CFG, SPEC) + CFG.fft_len
    caps = np.stack([cap[b * 2**13 : (b + 1) * 2**13 + halo] for b in range(2)])
    chans = (np.random.default_rng(4).normal(size=(2, CFG.n_virtual, CFG.fft_len, 2))
             .astype(np.float32).view(np.complex64)[..., 0])
    with mesh.local_group("nccl"):
        tm, bm = mesh.time_mesh(), mesh.batch_mesh()
        block = pstream.local_block(tm, cap[:n])
        assert pstream.captures(tm, block)
        runs = {
            "sharded_rx": lambda: pstream.sharded_rx(CFG, SPEC, tm, block,
                                                     max_frames_per_block=64),
            "sharded_rx_dynamic": lambda: pstream.sharded_rx_dynamic(
                CFG, tm, block, max_frames_per_block=64, max_payload=96),
            "batched_rx": lambda: batch.batched_rx(bm, CFG, SPEC, caps, max_frames=8),
            "batched_range_angle_maps": lambda: batch.batched_range_angle_maps(bm, chans),
        }
        for name, run in runs.items():
            with graph.eager():
                want = run()
            for _ in range(2):
                got = run()
                for k, (a, b) in enumerate(zip(_leaves(got), _leaves(want))):
                    assert torch.equal(a, b), (name, k)
        assert int(got.shape[0]) == 2
        assert len(mesh.captured_steps(tm)) == 2
        assert len(mesh.captured_steps(bm)) == 2


# ------------------------------------------------ the mesh across cards (NCCL)
#: one rank of test_multi_card_batched_captured_equals_eager: batched_rx on two
#: 8192-sample blocks of the bench capture a rank and batched_range_angle_maps on
#: two channel estimates a rank, each captured and against its graph.eager() run
BATCHED_RANK = """
import sys
import numpy as np, torch
from jrc_tpu_torch import capture
from jrc_tpu_torch.config import MCS, OFDMConfig, PacketType
from jrc_tpu_torch.models.streaming import frame_window_samples
from jrc_tpu_torch.ops.encoder import FrameSpec
from jrc_tpu_torch.parallel import batch, mesh, streaming
from jrc_tpu_torch.utils import graph

store, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = OFDMConfig()
spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
frame, _, halo = capture.load_bench_frame()
n = 2 * world
cap, _ = capture.build_capture(frame, n * 2**13, halo=halo)
halo = frame_window_samples(cfg, spec) + cfg.fft_len
caps = np.stack([cap[b * 2**13 : (b + 1) * 2**13 + halo] for b in range(n)])
chans = (np.random.default_rng(4).normal(size=(n, cfg.n_virtual, cfg.fft_len, 2))
         .astype(np.float32).view(np.complex64)[..., 0])
mesh.init_distributed(store, world, rank, backend="nccl")
try:
    bm = mesh.batch_mesh()
    runs = {"batched_rx": lambda: batch.batched_rx(bm, cfg, spec, caps, max_frames=8),
            "batched_range_angle_maps": lambda: batch.batched_range_angle_maps(bm, chans)}
    for name, run in runs.items():
        with graph.eager():
            want = run()
        for _ in range(2):
            got = run()
            assert torch.equal(got, want), name
        assert got.shape[0] == n, (name, got.shape)
    counts = runs["batched_rx"]()
    assert int(counts[:, 1].sum()) > 0 and torch.equal(counts[:, 0], counts[:, 1]), counts
    assert len(mesh.captured_steps(bm)) == 2
finally:
    mesh.teardown()
assert not mesh.captured_steps(bm)
print(f"BATCHED_OK rank={rank} world={world} frames={int(counts[:, 0].sum())}", flush=True)
"""


@pytest.fixture
def cards(dev):
    """The ranks of a multi-card test: one a card, at most four."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two CUDA devices (one NCCL rank a card); the host has {n}")
    return min(4, n)


def _ranks(argv_of, world: int, timeout: float) -> list[str]:
    """``world`` processes, ``argv_of(rank)`` each, from the repo root → each
    one's output; every one must exit 0 within ``timeout`` seconds (killed past it)."""
    import sys
    from pathlib import Path

    from jrc_tpu_torch.parallel.launch import run_ranks

    ranks = run_ranks(lambda r: [sys.executable, *argv_of(r)], world, timeout=timeout,
                      cwd=Path(__file__).resolve().parents[1])
    for r, (code, out) in enumerate(ranks):
        assert code == 0, f"rank {r} exited {code} (None: killed at {timeout} s):\n{out[-3000:]}"
    return [out for _, out in ranks]


def test_multi_card_dry_run(cards):
    """python -m jrc_tpu_torch.parallel.dryrun over NCCL at world = min(4,
    cards): every rank prints DRYRUN_OK with frames == CRC-clean == world on
    both sharded paths, every batched_rx row (1, 1), its steps captured and
    equal to their eager runs, and exits 0 within the launcher's limit."""
    from jrc_tpu_torch.parallel import dryrun

    outs = dryrun.launch(cards, cpu=False, timeout=300)
    rows = ";".join(["1,1"] * cards)
    for r, out in enumerate(outs):
        assert (f"DRYRUN_OK rank={r} world={cards} backend=nccl frames={cards} crc_ok={cards} "
                f"dynamic_frames={cards} dynamic_crc_ok={cards} batched={rows} ") in out, out
        assert "captured=True" in out


def test_multi_card_batched_captured_equals_eager(cards, tmp_path):
    """batched_rx and batched_range_angle_maps over a batch mesh of min(4,
    cards) NCCL ranks: each captured step equal to its graph.eager() run
    twice, the graphs freed by mesh.teardown, every rank exiting 0."""
    outs = _ranks(lambda r: ["-c", BATCHED_RANK, f"file://{tmp_path}/store", str(cards), str(r)],
                  cards, timeout=300)
    for r, out in enumerate(outs):
        assert f"BATCHED_OK rank={r} world={cards}" in out, out[-2000:]


def test_multi_card_bench_ranks_exit(cards, tmp_path):
    """scripts/multihost_rx_torch.py --backend nccl --dynamic --capture bench
    --bench 3 on min(4, cards) ranks, 2^23 samples over them: every rank finds
    the 2417 frames CRC-clean, equal to its op-by-op step, and exits 0 within
    180 s, after the teardown."""
    block_len = 2**23 // cards
    outs = _ranks(lambda r: ["scripts/multihost_rx_torch.py", "--coordinator",
                             f"file://{tmp_path}/store", "--num-processes", str(cards),
                             "--process-id", str(r), "--backend", "nccl", "--dynamic",
                             "--capture", "bench", "--block-len", str(block_len), "--bench", "3"],
                  cards, timeout=180)
    for r, out in enumerate(outs):
        assert (f"MULTIHOST_OK rank={r} n_frames=2417 crc_ok=2417 dynamic=True captured=True"
                in out), out[-2000:]
        assert f"MULTIHOST_EXIT rank={r}" in out
