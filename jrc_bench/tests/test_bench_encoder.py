"""The plain reference's TX chain against the frames the JAX package pinned:
the frozen copies of ``mixed_frames.npz`` and ``bench_frame_qpsk34_64B.npz``."""
from pathlib import Path

import numpy as np
import pytest

from jrc_bench import generate
from jrc_bench.reference import phy

DATA = Path(__file__).resolve().parents[1] / "data"
#: the pinned frames' kinds, in the order of mixed_frames.npz
MIXED = (("BPSK_1_2", 24, "DATA"), ("BPSK_3_4", 96, "DATA"), ("QPSK_1_2", 64, "DATA"),
         ("QPSK_3_4", 128, "DATA"), ("QAM16_1_2", 200, "DATA"), ("QAM16_3_4", 252, "DATA"),
         ("QPSK_1_2", 24, "NDP"))
#: float32 rounding: the largest |difference| to the JAX package's frames, about 4.2e-7
ATOL = 1e-6


def frame(kind, payload, scrambler_seed):
    return generate.tx_frame(generate.spec_of(kind), payload, scrambler_seed, path_loss=5.0,
                             cfo=0.02 * 2 * np.pi / 64)


@pytest.mark.parametrize("i", range(len(MIXED)))
def test_mixed_frame_reproduced(i):
    with np.load(DATA / "mixed_frames.npz") as f:
        want, payload = f[f"frame_{i}"], f[f"payload_{i}"]
        assert int(f["mcs"][i]) == phy.MCS_NAMES.index(generate.spec_of(MIXED[i]).mcs)
    got = frame(MIXED[i], payload, 1 + i)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_bench_frame_reproduced():
    with np.load(DATA / "bench_frame_qpsk34_64B.npz") as f:
        want, payload = f["frame"], f["payload"]
    got = frame(("QPSK_3_4", 64, "DATA"), payload, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
