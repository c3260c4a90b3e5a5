"""The count functions against hand counts at each cell's shapes."""
import pytest

from jrc_bench import counts
from jrc_bench.generate import spec_of


def test_rx_call_stream():
    # 384 samples of left history + 65536 + a halo of the 256-B BPSK-1/2 window (88 data
    # symbols: 4·80 + 2·64 + (2 + 1 + 4 + 88 − 2)·80 + 64 = 7952) + 64
    n = counts.rx_stream_samples(65536, 1, 256)
    assert n == 384 + 65536 + 8016 == 73936
    assert counts.stream_work(n)["detect"] == [(16 * 73936 + 8 * 578, 20 * 73936)]


def test_rx_call_stream_published_envelope():
    # the 3100-B envelope: 1036 BPSK-1/2 data symbols, a halo of
    # 4·80 + 2·64 + (2 + 1 + 4 + 1036 − 2)·80 + 64 + 64 = 83856 samples
    n = counts.rx_stream_samples(65536, 1, 3100)
    assert n == 384 + 65536 + 83856 == 149776


@pytest.mark.parametrize("kind, n_sym, width, t", [
    (("QPSK_3_4", 80, "DATA"), 10, 2 * 64 + (2 + 1 + 4 + 10 - 2) * 80, 10 * 72),
    (("QPSK_3_4", 1500, "DATA"), 168, 2 * 64 + (2 + 1 + 4 + 168 - 2) * 80, 168 * 72),
    (("QPSK_1_2", 24, "NDP"), 6, 2 * 64 + (2 + 1 + 4 + 6 - 2) * 80, 6 * 48),
    (("QAM16_3_4", 252, "DATA"), 15, 2 * 64 + (2 + 1 + 4 + 15 - 2) * 80, 15 * 144),
    (("BPSK_1_2", 24, "DATA"), 11, 2 * 64 + (2 + 1 + 4 + 11 - 2) * 80, 11 * 24),
])
def test_frame_work(kind, n_sym, width, t):
    spec = spec_of(kind)
    assert spec.n_sym == n_sym
    w = counts.frame_work(spec)
    # the LTF search window: 4 sync words of 80 + 64 − 1 samples; rows read and written once
    assert w["gather"] == [(16 * 383 + 20, 0), (16 * width + 20, 0)]
    # (2T values of 4 B in, T bits of 1 B out), 64 states · 5 operations a step
    assert w["viterbi"] == [(9 * 24, 24 * 320), (9 * t, t * 320)]


@pytest.mark.parametrize("kind, n", [(("QPSK_3_4", 80, "DATA"), 2800),
                                     (("QPSK_3_4", 1500, "DATA"), 15440),
                                     (("QPSK_1_2", 24, "NDP"), 2480)])
def test_dwell_stream(kind, n):
    assert counts.dwell_stream_samples(spec_of(kind)) == n


def test_bound_and_merge():
    assert counts.bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert counts.bound_ms(0, 67e9) == pytest.approx(1.0)
    w = counts.merge([counts.stream_work(128), counts.stream_work(128)])
    assert counts.kernel_bound_ms(w, "detect") == pytest.approx(2 * (16 * 128 + 8) / 3.35e9)
    assert counts.kernel_bound_ms(w, "viterbi") is None
