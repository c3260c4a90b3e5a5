"""The port's link evaluation against jrc_tpu on the CPU: ``LinkStats`` over
a CRC sequence longer than its window, ``coding_bit_errors``, the batched
receive chain against ``rx_chain`` burst by burst, and ``link_curve`` for
BPSK-1/2 and 16-QAM-3/4 (64-B payloads) at a waterfall SNR and a clean SNR
with the reference's own noise draws (``jax.random.split(PRNGKey(seed +
1000·i), n_frames)``, each drawn as ``channel.awgn`` draws it).

Tolerances: bit errors, CRC flags, payloads, triggers, SIG fields and the
BER / PER of each point are equal. The batched chain's floats equal
``rx_chain``'s within 1e-6 · max (SNR within 1e-4 dB): the same operations
on B rows at once. ``per_percent`` within 1e-4 %."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrc_tpu.models import comm_link as jcomm_link, evaluation as jevaluation
from jrc_tpu.ops import channel as jchannel, cplx as cx, decoder as jdecoder
from jrc_tpu.ops.encoder import make_payload as jmake_payload
from jrc_tpu_torch.config import MCS, PacketType
from jrc_tpu_torch.models import comm_link, evaluation
from jrc_tpu_torch.ops import channel, decoder
from jrc_tpu_torch.ops.encoder import make_payload
from tests.torch_parity import CFG, JCFG, awgn_draws, jit_reference, specs, tab

SEED = 7  # tests/golden_ber.json's
N_FRAMES = 6
#: (mcs, waterfall SNR, clean SNR) from tests/golden_ber.json
POINTS = [(MCS.BPSK_1_2, 0.0, 4.0), (MCS.QAM16_3_4, 10.0, 15.0)]


def test_link_stats_match_over_a_long_sequence(rng):
    crcs = rng.random(40) < 0.7
    ours, ref = decoder.init_stats(device="cpu"), jdecoder.init_stats()
    for c in crcs:
        ours = decoder.update_stats(ours, bool(c))
        ref = jdecoder.update_stats(ref, jnp.float32(c))
        np.testing.assert_array_equal(ours.crc_history.numpy(), np.asarray(ref.crc_history))
        assert int(ours.count) == int(ref.count)
        assert abs(float(decoder.per_percent(ours)) - float(jdecoder.per_percent(ref))) <= 1e-4
    assert int(ours.count) == 40 and ours.crc_history.shape == (25,)
    assert float(decoder.per_percent(ours)) == pytest.approx(100 * (~crcs[-25:]).mean(), abs=1e-4)
    assert float(decoder.per_percent(decoder.init_stats(device="cpu"))) == 0.0


def test_coding_bit_errors_match(rng):
    a, b = rng.integers(0, 256, (3, 70)), rng.integers(0, 256, (3, 70))
    got = evaluation.coding_bit_errors(torch.from_numpy(a).to(torch.uint8),
                                       torch.from_numpy(b).to(torch.uint8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jevaluation.coding_bit_errors(
        jnp.asarray(a), jnp.asarray(b))))


def _frame(mcs):
    """(port spec, reference spec, payloads) of apps/ber_sweep.py's 64-B frame."""
    spec, jspec = specs(mcs, 64, PacketType.DATA)
    filler = (bytes([2]) + b"ber sweep " * 6)[:64]
    return spec, jspec, torch.from_numpy(make_payload(spec, filler)), jnp.asarray(
        jmake_payload(jspec, filler))


def _reference_frames(jspec, jpayload, snrs):
    """The reference's per-frame (bit errors, CRC flags) at each SNR: its
    link_curve's own vmapped loop, read before the sums, with the
    reference's pieces under jax.jit as apps/ber_sweep.py's twin runs them
    (eagerly they are 10 s of op-by-op compiles for two MCS; the same
    compiled loop then serves the BPSK-1/2 twin)."""
    tx = jcomm_link.tx_frame(JCFG, jspec, jpayload, 1, pad_front=5 * JCFG.sym_len,
                             pad_tail=6 * JCFG.sym_len + 10)
    clean = jchannel.comm_channel(tx.samples, angle_deg=0.0, path_loss=10.0, noise_var=0.0,
                                  cfo=0.0)
    sig_pow = float(jnp.mean(cx.abs2(clean)))
    run = jax.jit(jax.vmap(partial(jevaluation._loopback_once, JCFG, jspec, jpayload, clean,
                                   estimator="ls", soft=False), in_axes=(0, None)))
    out = []
    for i, snr in enumerate(snrs):
        keys = jax.random.split(jax.random.PRNGKey(SEED + 1000 * i), N_FRAMES)
        errs, ok = run(keys, jnp.float32(sig_pow / 10.0 ** (snr / 10.0)))
        out.append((np.asarray(errs), np.asarray(ok), awgn_draws(keys, clean.re.shape[-1])))
    return out


@pytest.mark.parametrize("mcs,waterfall,clean", POINTS, ids=lambda v: getattr(v, "name", v))
def test_link_curve_matches_per_frame(mcs, waterfall, clean, monkeypatch):
    jit_reference(monkeypatch)
    spec, jspec, payload, jpayload = _frame(mcs)
    snrs = [waterfall, clean]
    want = _reference_frames(jspec, jpayload, snrs)
    points = []
    curve = evaluation.link_curve(CFG, spec, tab(spec), payload, snrs, n_frames=N_FRAMES,
                                  seed=SEED, noise=[torch.from_numpy(z) for _, _, z in want],
                                  points=points)
    for (errs, ok, _), got, pt, snr in zip(want, points, curve, snrs):
        np.testing.assert_array_equal(got.bit_errors.numpy(), errs)
        np.testing.assert_array_equal(got.crc_ok.numpy(), ok)
        assert pt == evaluation.LinkPoint(float(snr), errs.sum() / (N_FRAMES * 8 * 64),
                                          1.0 - ok.sum() / N_FRAMES, N_FRAMES)
    assert curve[0].per > 0 and curve[1].per == 0.0  # errors at the waterfall, none when clean


def _bursts(spec, payload, snr_db: float, b: int, cfo: float = 0.0):
    clean = evaluation.clean_waveform(CFG, spec, tab(spec), payload, cfo=cfo)
    nv = float(np.float32(float((clean.abs() ** 2).mean()) / 10.0 ** (snr_db / 10.0)))
    noise = channel.normal_pair((b, clean.shape[-1]), generator=torch.Generator().manual_seed(3))
    return comm_link.guard(CFG, channel.awgn(clean.expand(b, -1), nv, noise=noise))


def _row(x, i):
    return type(x)(*(_row(f, i) for f in x)) if isinstance(x, tuple) else x[i]


def _same(got, want, path):
    if isinstance(got, tuple):
        for f, g, w in zip(got._fields, got, want):
            _same(g, w, f"{path}.{f}")
    elif got.is_floating_point() or got.is_complex():
        scale = float(want.abs().max()) if want.numel() else 0.0
        tol = 1e-4 if "snr" in path else 1e-6 * scale
        assert float((got - want).abs().max()) <= tol, path
    else:
        assert torch.equal(got, want), path


@pytest.mark.parametrize("mcs,snr_db,cfo", [(MCS.QPSK_3_4, 7.5, 0.0), (MCS.BPSK_1_2, 0.0, 0.01),
                                            (MCS.QAM16_3_4, 30.0, 0.02)],
                         ids=["waterfall", "low-snr-cfo", "clean-cfo"])
def test_batched_rx_equals_rx_chain_per_burst(mcs, snr_db, cfo):
    """rx_chain_batch over 4 guarded bursts equals rx_chain on each burst in
    every field (detection burst-relative), frames that fail their CRC and
    late triggers (BPSK at 0 dB) included."""
    spec, _, payload, _ = _frame(mcs)
    rx = _bursts(spec, payload, snr_db, 4, cfo)
    batch = comm_link.rx_chain_batch(CFG, spec, tab(spec), rx)
    for i in range(rx.shape[0]):
        one = comm_link.rx_chain(CFG, spec, tab(spec), rx[i])
        _same(_row(batch, i), one, f"burst {i}")
