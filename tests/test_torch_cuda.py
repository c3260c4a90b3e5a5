"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports neither jax nor the JAX package, so it also runs on a machine
that has no jax, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu.config import MCS, OFDMConfig, PacketType  # noqa: E402
from jrc_tpu_torch import capture, tables  # noqa: E402
from jrc_tpu_torch.models.streaming import StreamingRx  # noqa: E402
from jrc_tpu_torch.ops import detect_cuda, gather_cuda, viterbi, viterbi_cuda  # noqa: E402
from jrc_tpu_torch.ops.encoder import FrameSpec  # noqa: E402

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


@pytest.mark.parametrize("b,t", [(5, 100), (3072, 576)])
def test_viterbi_kernels_match_plain(dev, b, t):
    """Soft values with 20% erasures: decision words, end states and bits
    exactly equal."""
    rng = np.random.default_rng(b * 1000 + t)
    vals = rng.normal(0, 1, (b, 2 * t)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.2] = 0.0
    v = torch.from_numpy(vals).to(dev)
    trellis = tables.from_numpy(CFG, SPEC, dev).trellis
    words_k, end_k = viterbi_cuda.viterbi_acs(v, trellis)
    words_p, end_p = viterbi.viterbi_acs_plain(v, trellis)
    assert torch.equal(words_k, words_p) and torch.equal(end_k, end_p)
    assert torch.equal(viterbi_cuda.viterbi_traceback(words_p, end_p),
                       viterbi.viterbi_traceback_plain(words_p, end_p))


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


def test_gather_kernel_matches_plain(dev):
    """Starts clamped at both ends, both main-path widths: exactly equal."""
    rng = np.random.default_rng(3)
    n = 50_000
    x = torch.from_numpy((rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)).to(dev)
    starts = torch.from_numpy(rng.integers(-500, n + 500, 777)).to(dev)
    for width in (383, 1168):
        assert torch.equal(gather_cuda.gather_rows(x, starts, width),
                           gather_cuda.gather_rows_plain(x, starts, width))


def test_streaming_rx_kernel_path_matches_plain_path(dev):
    """A small bench capture through StreamingRx: every frame decodes, the
    kernels ran, and the plain versions on the card give the same frames."""
    frame, payload, halo = capture.load_bench_frame()
    cap, n_frames = capture.build_capture(frame, 4 * 2**13, halo=halo)
    model = StreamingRx(CFG, SPEC, 2**13, 4, max_frames_per_block=4).to(dev)
    x = torch.from_numpy(cap).to(dev)
    before = viterbi_cuda.viterbi_acs.launches
    res = model(x)
    assert viterbi_cuda.viterbi_acs.launches > before
    assert int(res.valid.sum()) == int(res.crc_ok.sum()) == n_frames
    assert (res.payload[res.valid].cpu().numpy() == payload).all()
    originals = (viterbi_cuda.viterbi_acs, viterbi_cuda.viterbi_traceback,
                 detect_cuda.detect_front_end, gather_cuda.gather_rows)
    try:
        viterbi_cuda.viterbi_acs = viterbi.viterbi_acs_plain
        viterbi_cuda.viterbi_traceback = viterbi.viterbi_traceback_plain
        detect_cuda.detect_front_end = detect_cuda.detect_front_end_plain
        gather_cuda.gather_rows = gather_cuda.gather_rows_plain
        plain = model(x)
    finally:
        (viterbi_cuda.viterbi_acs, viterbi_cuda.viterbi_traceback,
         detect_cuda.detect_front_end, gather_cuda.gather_rows) = originals
    for f in ("valid", "start", "crc_ok", "sig_ok", "payload"):
        assert torch.equal(getattr(res, f), getattr(plain, f)), f
