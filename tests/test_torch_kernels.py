"""The port's RX-path kernels: each plain PyTorch version against the JAX
package's Pallas kernel (run in interpret mode, as
tests/test_pallas_interpret.py runs it) and its XLA formulation, and the
fused decoder's choice of where it keeps its decision words. The CUDA
kernels against their plain versions: tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu.config import OFDMConfig  # noqa: E402
from jrc_tpu.ops import cplx as cx, detect_pallas as dp  # noqa: E402
from jrc_tpu.ops.gather_pallas import gather_rows as j_gather_rows  # noqa: E402
from jrc_tpu.ops.viterbi import viterbi_decode as j_viterbi_decode  # noqa: E402
from jrc_tpu.ops.viterbi_pallas import viterbi_decode_pallas  # noqa: E402
from jrc_tpu_torch.ops import detect_cuda, gather_cuda, viterbi, viterbi_cuda  # noqa: E402
from jrc_tpu_torch.ops.viterbi import viterbi_decode_plain  # noqa: E402
from tests.torch_parity import THREADS  # noqa: E402,F401 (the one-thread pool)

CFG = OFDMConfig()
TRELLIS = tuple(torch.as_tensor(a).to(torch.int64 if a.dtype == np.int32 else torch.float32)
                for a in viterbi._trellis())
DETECT_KW = dict(threshold=0.6, min_n_peaks=10, max_peak_distance=2 * CFG.sym_len,
                 lag=CFG.fft_len // 4, win=CFG.fft_len // 2,
                 pwin=int(1.5 * (CFG.fft_len // 2)))


def _soft_values(b, t, erasures=0.2):
    rng = np.random.default_rng(b * 1000 + t)
    vals = rng.normal(0, 1, (b, 2 * t)).astype(np.float32)
    vals[rng.random(vals.shape) < erasures] = 0.0
    return vals


@pytest.mark.parametrize("b,t,erasures", [
    (5, 100, 0.2), (3, 576, 0.2), (2, 864, 0.2),
    (4, 24, 0.2),  # the SIG call
    (3, 96, 1.0),  # all erasures: every compare a tie
], ids=["5-100", "3-576", "2-864", "4-24", "3-96-erasures"])
def test_viterbi_plain_matches_reference(b, t, erasures):
    """Bits exactly equal to viterbi.viterbi_decode and to the Pallas
    kernel pair in interpret mode."""
    vals = _soft_values(b, t, erasures)
    ours = viterbi_decode_plain(torch.from_numpy(vals), TRELLIS).numpy()
    np.testing.assert_array_equal(ours, np.asarray(j_viterbi_decode(vals)))
    np.testing.assert_array_equal(ours, np.asarray(viterbi_decode_pallas(vals, interpret=True)))
    # the CPU wrapper is the plain version, with n_out truncation
    np.testing.assert_array_equal(
        viterbi_cuda.viterbi_decode(torch.from_numpy(vals), TRELLIS, n_out=t - 7).numpy(),
        ours[:, : t - 7])


@pytest.mark.parametrize("b", [1, 5, 3072])
@pytest.mark.parametrize("t", [24, 576, 864, 2160, 24864])
def test_viterbi_decision_route(b, t):
    """Shared memory while the whole batch is resident at 8 bytes a step and
    512 staging bytes per frame, four frames a block, 228 KB an SM less 1 KB
    per block, 132 SMs; else the scratch route. 24 864 steps are a
    3100-byte BPSK-1/2 frame."""
    block = 4 * (8 * t + 512)
    fits = block <= 227 * 1024
    resident = 132 * (228 * 1024 // (block + 1024)) * 4
    want = "shared" if fits and b <= resident else "global"
    assert viterbi_cuda.decision_route(b, t) == want
    assert want == {(3072, 2160): "global"}.get((b, t), "global" if t == 24864 else "shared")


def test_viterbi_decode_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="odd"):
        viterbi_cuda.viterbi_decode(torch.zeros(2, 21, device="meta"), None)
    with pytest.raises(ValueError, match="route"):
        viterbi_cuda.viterbi_decode(torch.zeros(2, 20, device="meta"), None, route="l2")
    with pytest.raises(ValueError, match="shared"):
        viterbi_cuda.viterbi_decode(torch.zeros(2, 2 * 24864, device="meta"), None, route="shared")
    assert viterbi_cuda.shared_block_bytes(575) == viterbi_cuda.shared_block_bytes(576)


def _plateau_stream(n_chunks):
    """The STF-plateau input of tests/test_pallas_interpret.py."""
    n = n_chunks * dp.CHUNK_ROWS * dp.LANE
    rng = np.random.default_rng(n_chunks)
    x = rng.normal(0, 0.1, n).astype(np.float32) + 1j * rng.normal(0, 0.1, n).astype(np.float32)
    block = rng.normal(0, 1, 16) + 1j * rng.normal(0, 1, 16)
    for pos in (1000, 5000, n // 2 - 200, n - 3000):
        x[pos : pos + 800] = np.tile(block, 50)
    return x.astype(np.complex64)


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_detect_plain_matches_pallas(n_chunks):
    x = _plateau_stream(n_chunks)
    n = len(x)
    xp = cx.from_complex(jnp.asarray(x))
    a_re, a_im, first, count = dp.detect_front_end(xp.re, xp.im, interpret=True, **DETECT_KW)
    a, first_t, count_t = detect_cuda.detect_front_end_plain(torch.from_numpy(x), **DETECT_KW)
    n_seg = -(-n // 128)
    assert int(count_t.sum()) >= 4  # the plateaus did trigger
    np.testing.assert_array_equal(first_t.numpy(), np.asarray(first[:n_seg]))
    np.testing.assert_array_equal(count_t.numpy(), np.asarray(count[:n_seg]))
    np.testing.assert_allclose(a.real.numpy(), np.asarray(a_re[:n]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a.imag.numpy(), np.asarray(a_im[:n]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,width,starts", [
    (8192, 300, None),  # unaligned random starts
    (2048, 256, [-5, 2038, 2148, 0]),  # clamped like dynamic_slice
])
def test_gather_plain_matches_pallas(n, width, starts):
    rng = np.random.default_rng(7)
    xs = rng.normal(0, 1, (2, n)).astype(np.float32)
    if starts is None:
        starts = rng.integers(0, n - width, 11)
    starts = np.asarray(starts, np.int32)
    ref = j_gather_rows(cx.CArray(jnp.asarray(xs[0]), jnp.asarray(xs[1])),
                        jnp.asarray(starts), width, interpret=True)
    x = torch.complex(torch.from_numpy(xs[0]), torch.from_numpy(xs[1]))
    out = gather_cuda.gather_rows(x, torch.from_numpy(starts), width)
    np.testing.assert_array_equal(out.real.numpy(), np.asarray(ref.re))
    np.testing.assert_array_equal(out.imag.numpy(), np.asarray(ref.im))


def test_gather_rejects_short_stream():
    with pytest.raises(ValueError):
        gather_cuda.gather_rows_plain(torch.zeros(10, dtype=torch.complex64),
                                      torch.zeros(1, dtype=torch.int64), 11)
