"""The PyTorch port's scan_rx against jrc_tpu's on every MCS: two
2^13-sample blocks of 24-byte frames with the bench CFO and 25 dB AWGN.
Triggers, starts, CRC flags and valid payloads exactly equal; SNR within
1e-3 dB."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu.config import MCS  # noqa: E402
from jrc_tpu_torch.models import streaming as tst  # noqa: E402
from tests.torch_parity import (  # noqa: E402
    CFG, assert_same_rx, jax_scan_rx, specs, t, tab, tx_frame,
)


@pytest.mark.parametrize("mcs", list(MCS))
def test_scan_rx_matches_every_mcs(mcs):
    """Two 2^13-sample blocks per MCS with CFO and 25 dB AWGN."""
    spec, jspec = specs(mcs, 24)
    frame, payload = tx_frame(jspec, mcs.name.encode(), cfo=0.02 * 2 * np.pi / CFG.fft_len)
    block_len, n_blocks = 2**13, 2
    rng = np.random.default_rng(int(mcs))
    noise_var = float(np.mean(np.abs(frame) ** 2)) / 10 ** 2.5
    n_total = n_blocks * block_len + tst.frame_window_samples(CFG, spec) + CFG.fft_len
    cap = (rng.normal(0, np.sqrt(noise_var / 2), (n_total, 2)) @ [1, 1j]).astype(np.complex64)
    pos, n_frames = 300, 0
    while pos + len(frame) < n_blocks * block_len:
        cap[pos : pos + len(frame)] += frame
        pos += len(frame) + 1500
        n_frames += 1
    ours = tst.scan_rx(CFG, spec, tab(spec), t(cap), block_len, n_blocks,
                       max_frames_per_block=4)
    assert_same_rx(ours, jax_scan_rx(jspec, cap, block_len, n_blocks, 4), payload_slots="valid")
    valid = ours.valid.numpy()
    assert int(valid.sum()) == int(ours.crc_ok.sum()) == n_frames
    assert (ours.payload.numpy()[valid] == payload).all()
