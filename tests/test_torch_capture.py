"""The port's numpy-only capture function reproduces bench.build_capture
sample for sample from the pinned TX frame."""
import numpy as np
import pytest

pytest.importorskip("torch")

import bench  # noqa: E402
from jrc_tpu.config import MCS, OFDMConfig, PacketType  # noqa: E402
from jrc_tpu.ops.encoder import FrameSpec, make_payload  # noqa: E402
from jrc_tpu_torch import capture  # noqa: E402
from tests.torch_parity import THREADS  # noqa: E402,F401 (the one-thread pool)


def test_capture_matches_bench():
    cfg = OFDMConfig()
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    n_samples = 3 * 2**13
    ref, n_ref = bench.build_capture(cfg, spec, n_samples)
    frame, payload, halo = capture.load_bench_frame()
    ours, n_ours = capture.build_capture(frame, n_samples, halo=halo)
    assert n_ours == n_ref > 0
    assert ours.dtype == ref.dtype == np.complex64
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(payload, make_payload(spec, bytes([2]) + b"bench frame"))
    assert frame.shape == (1360,)


def test_mixed_fixture_matches_reference_tx():
    """The pinned mixed-traffic frames are what the reference TX chain and
    channel give today (scripts/pin_torch_capture.py rewrites them)."""
    from scripts import pin_torch_capture

    want = pin_torch_capture.mixed_frames()
    frames = capture.load_mixed_frames()
    assert len(frames) == len(pin_torch_capture.MIXED_TRAFFIC) == 7
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(f.samples, want[f"frame_{i}"])
        np.testing.assert_array_equal(f.payload, want[f"payload_{i}"])
        assert f.samples.dtype == np.complex64
    assert [f.mcs for f in frames] == want["mcs"].tolist() == [0, 1, 2, 3, 4, 5, 2]
    assert [f.packet_type_bit for f in frames] == want["packet_type_bit"].tolist()
    assert [len(f.payload) for f in frames] == [24, 96, 64, 128, 200, 252, 24]


def test_build_mixed_capture_places_frames_in_turn():
    frames = [np.full(100, 1 + 0j, np.complex64), np.full(60, 2 + 0j, np.complex64)]
    cap, placed = capture.build_mixed_capture(frames, 1000, gap=50, snr_db=200.0, halo=7)
    assert cap.shape == (1007,) and cap.dtype == np.complex64
    assert placed.tolist() == [[500, 0], [650, 1], [760, 0]]  # 910 + 60 >= 1000 - 100 stops
    np.testing.assert_allclose(cap[500:600].real, 1, atol=1e-6)
    np.testing.assert_allclose(cap[650:710].real, 2, atol=1e-6)
    np.testing.assert_allclose(cap[760:860].real, 1, atol=1e-6)
    assert not cap[1000:].any()
