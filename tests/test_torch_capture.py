"""The port's numpy-only capture function reproduces bench.build_capture
sample for sample from the pinned TX frame."""
import numpy as np
import pytest

pytest.importorskip("torch")

import bench  # noqa: E402
from jrc_tpu.config import MCS, OFDMConfig, PacketType  # noqa: E402
from jrc_tpu.ops.encoder import FrameSpec, make_payload  # noqa: E402
from jrc_tpu_torch import capture  # noqa: E402


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
