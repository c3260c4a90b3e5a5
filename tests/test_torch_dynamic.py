"""Parity of the port's SIG-driven dynamic RX path with jrc_tpu on the CPU:
the dynamic tables, the length-limited CRC, the NDP channel estimate and
the per-MCS demap module by module, then scan_rx_dynamic on a mixed
capture (all six MCS and an NDP frame, bench CFO, 25 dB AWGN, two 2^13
blocks, max_payload 96; the reference decodes with its scan Viterbi).

Tolerances: integer, flag and payload fields exactly equal; SNRs within
1e-3 dB and the NDP estimate within 1e-5·max|h| (torch.fft and complex
division round differently from the reference's DFT matmul and pair form).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu.config import MCS, MCSParams, PacketType  # noqa: E402
from jrc_tpu.models import streaming as jst  # noqa: E402
from jrc_tpu.ops import (  # noqa: E402
    coding as jcoding, cplx as cx, dynamic_rx as jdyn, equalizer as jeq,
)
from jrc_tpu_torch import capture, tables  # noqa: E402
from jrc_tpu_torch.models import streaming as tst  # noqa: E402
from jrc_tpu_torch.ops import coding, dynamic_rx, equalizer, sync  # noqa: E402
from scripts import pin_torch_capture  # noqa: E402
from tests.torch_parity import CFG, JCFG, cplx as _cplx, np_of as _np, t as _t  # noqa: E402

MAXP = 96
BLOCK_LEN, N_BLOCKS, MAX_FRAMES = 2**13, 2, 4
#: one frame per MCS plus an NDP frame, payloads spread up to MAXP
TRAFFIC = [
    (MCS.BPSK_1_2, 16, PacketType.DATA),
    (MCS.BPSK_3_4, 40, PacketType.DATA),
    (MCS.QPSK_1_2, 24, PacketType.DATA),
    (MCS.QPSK_3_4, 64, PacketType.DATA),
    (MCS.QAM16_1_2, 80, PacketType.DATA),
    (MCS.QAM16_3_4, MAXP, PacketType.DATA),
    (MCS.QPSK_1_2, 12, PacketType.NDP),
]


def _dyn_tab(max_payload=MAXP):
    return tables.from_numpy_dynamic(CFG, max_payload, "cpu")


# ---------------------------------------------------------------- tables


def test_dynamic_tables_equal_reference():
    tab = _dyn_tab()
    crc_T, crc_E = jcoding._crc32_linear_tables(MAXP + 4)
    from jrc_tpu.config import mcs_tables
    from jrc_tpu.ops import modulation as jmod, viterbi as jvit
    prev, sa, sb = jvit._trellis()
    ref = dict(
        data_idx=JCFG.data_carrier_idx, pilot_idx=JCFG.pilot_carrier_idx,
        active_idx=JCFG.active_carrier_idx, lltf_freq=JCFG.lltf_freq,
        pilot_symbols=JCFG.pilot_symbols,
        ltf0_conj=np.conj(JCFG.ltf_mapped_sc_ss_sym[:, 0, :]),
        ltf_conj=np.conj(JCFG.ltf_mapped_sc_ss_sym),
        trellis_prev=prev, trellis_sign_a=sa, trellis_sign_b=sb,
        points_bpsk=jmod.constellation(1), points_qpsk=jmod.constellation(2),
        points_qam16=jmod.constellation(4),
        rate_lut=jdyn._RATE_LUT, rate_valid=jdyn._RATE_VALID,
        n_dbps=mcs_tables(JCFG.n_data_carriers)[2],
        n_bpsc=mcs_tables(JCFG.n_data_carriers)[0],
        descramble_basis=jcoding._descramble_basis(16 + 8 * (MAXP + 4) - 7),
        crc_T=crc_T, crc_E=crc_E,
    )
    assert set(ref) == set(tab._fields)
    for name, want in ref.items():
        np.testing.assert_array_equal(getattr(tab, name).numpy(), np.asarray(want), err_msg=name)


@pytest.mark.parametrize("max_payload", [96, 256])
def test_dynamic_geometry_matches(max_payload):
    assert dynamic_rx.max_symbols(max_payload) == jdyn.max_symbols(max_payload)
    assert dynamic_rx.max_trellis_bits(max_payload) == jdyn.max_trellis_bits(max_payload)
    assert (tst.frame_window_samples_dynamic(CFG, max_payload)
            == jst.frame_window_samples_dynamic(JCFG, max_payload))
    mcs = np.repeat(np.arange(6), 4)
    n_bytes = np.tile([4, 17, 100, max_payload + 4], 6)
    n_sym, n_bits = dynamic_rx.frame_geometry(_dyn_tab(max_payload), _t(mcs), _t(n_bytes))
    r_sym, r_bits = jdyn.frame_geometry(jnp.asarray(mcs), jnp.asarray(n_bytes))
    np.testing.assert_array_equal(n_sym.numpy(), np.asarray(r_sym))
    np.testing.assert_array_equal(n_bits.numpy(), np.asarray(r_bits))


# ---------------------------------------------------------------- coding


def test_crc_with_n_valid_matches():
    """Per-row lengths, 0 and n included: equal to the reference and to
    zlib on the valid prefix."""
    rng = np.random.default_rng(11)
    n = 40
    data = rng.integers(0, 256, (8, n)).astype(np.uint8)
    n_valid = np.array([0, 1, 4, 13, 20, 39, n, 7])
    for r, k in zip(data, n_valid[:7]):  # rows 0-6 carry a valid FCS
        if k >= 4:
            r[k - 4 : k] = np.frombuffer(zlib.crc32(r[: k - 4].tobytes()).to_bytes(4, "little"),
                                         np.uint8)
    crc_T, crc_E = (torch.as_tensor(a.astype(np.int64)) for a in coding._crc32_linear_tables(n))
    got = coding.crc32_bytes(_t(data), crc_T, crc_E, n_valid=_t(n_valid)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jcoding.crc32_bytes(jnp.asarray(data), jnp.asarray(n_valid))))
    np.testing.assert_array_equal(got[1:], [zlib.crc32(r[:k].tobytes())
                                            for r, k in zip(data[1:], n_valid[1:])])
    ok = coding.crc32_check_residue(_t(data), crc_T, crc_E, n_valid=_t(n_valid)).numpy()
    np.testing.assert_array_equal(
        ok, np.asarray(jcoding.crc32_check_residue(jnp.asarray(data), jnp.asarray(n_valid))))
    np.testing.assert_array_equal(ok, [False, False, True, True, True, True, True, False])


# ------------------------------------------------------------- equalizer


def test_ndp_channel_estimate_matches():
    y = _cplx(np.random.default_rng(12), 5, CFG.n_ltf, CFG.fft_len)
    h, h_mean = equalizer.mimo_channel_estimate_ndp(_dyn_tab(), _t(y))
    ref = [jeq.mimo_channel_estimate_ndp(JCFG, cx.from_complex(yy)) for yy in y]
    for b, (rh, rm) in enumerate(ref):
        scale = np.abs(_np(rh)).max()
        np.testing.assert_allclose(h[b].numpy(), _np(rh), rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(h_mean[b].numpy(), _np(rm), rtol=0, atol=1e-5 * scale)


# --------------------------------------------------------------- demap


@pytest.mark.parametrize("mcs", list(MCS))
def test_payload_values_dynamic_matches(mcs):
    """Every MCS at several lengths, frames of all six MCS in one batch (the
    port groups them by MCS): values bit-equal, erasures and zero padding
    included."""
    rng = np.random.default_rng(int(mcs) + 20)
    tab = _dyn_tab()
    lengths = np.array([4, 9, 30, 61, MAXP + 4])
    mcs_idx = np.concatenate([np.full(len(lengths), int(mcs)), rng.integers(0, 6, 3)])
    n_bytes = np.concatenate([lengths, rng.integers(4, MAXP + 5, 3)])
    max_n_sym = dynamic_rx.max_symbols(MAXP)
    z = _cplx(rng, len(mcs_idx), max_n_sym, 48)
    n_sym, _ = jdyn.frame_geometry(jnp.asarray(mcs_idx), jnp.asarray(n_bytes))
    z[np.arange(max_n_sym)[None, :] >= np.asarray(n_sym)[:, None]] = 0  # masked past n_sym
    got = dynamic_rx.payload_values_dynamic(tab, _t(z), _t(mcs_idx), _t(n_bytes), MAXP).numpy()
    want = np.asarray(jax.vmap(lambda zz, m, nb: jdyn.payload_values_dynamic(zz, m, nb, MAXP))(
        cx.from_complex(z), jnp.asarray(mcs_idx, jnp.int32), jnp.asarray(n_bytes, jnp.int32)))
    np.testing.assert_array_equal(got, want)
    n_bits = MCSParams(mcs).n_dbps * np.asarray(n_sym)[: len(lengths)]
    for row, nb in zip(got[: len(lengths)], n_bits):
        assert not row[2 * nb :].any()  # erased past the frame's coded extent


def test_payload_from_bits_dynamic_matches():
    rng = np.random.default_rng(13)
    n_out = 16 + 8 * (MAXP + 4)
    bits = rng.integers(0, 2, (6, n_out)).astype(np.uint8)
    n_bytes = np.array([4, 20, 50, 77, MAXP + 4, 33])
    pdu, ok = dynamic_rx.payload_from_bits_dynamic(_dyn_tab(), _t(bits), _t(n_bytes), MAXP)
    r_pdu, r_ok = jdyn.payload_from_bits_dynamic(jnp.asarray(bits), jnp.asarray(n_bytes), MAXP)
    np.testing.assert_array_equal(pdu.numpy(), np.asarray(r_pdu))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(r_ok))


# ------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def mixed_capture():
    """The TRAFFIC frames once each, 900 samples apart, over 25 dB AWGN."""
    frames, payloads = [], []
    for i, (mcs, n_bytes, ptype) in enumerate(TRAFFIC):
        f, p = pin_torch_capture.tx_frame(mcs, n_bytes, ptype, f" {mcs.name}".encode(), seed=3 + i)
        frames.append(f)
        payloads.append(p)
    halo = tst.frame_window_samples_dynamic(CFG, MAXP) + CFG.fft_len
    cap, placed = capture.build_mixed_capture(frames, N_BLOCKS * BLOCK_LEN, gap=900, seed=5,
                                              halo=halo)
    assert placed[:, 1].tolist() == list(range(len(TRAFFIC)))
    return cap, placed, payloads


def test_scan_rx_dynamic_matches_on_mixed_capture(mixed_capture):
    cap, placed, payloads = mixed_capture
    ours = tst.scan_rx_dynamic(CFG, _dyn_tab(), _t(cap), BLOCK_LEN, N_BLOCKS,
                               max_frames_per_block=MAX_FRAMES, max_payload=MAXP)
    ref = jax.jit(lambda x: jst.scan_rx_dynamic(
        JCFG, x, BLOCK_LEN, N_BLOCKS, max_frames_per_block=MAX_FRAMES,
        max_payload=MAXP))(jnp.asarray(cap))
    for f in ("valid", "start", "crc_ok", "sig_ok", "mcs", "packet_type_bit", "payload_len",
              "chan_est_ok"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    valid = ours.valid.numpy()
    np.testing.assert_array_equal(ours.payload.numpy()[valid], np.asarray(ref.payload)[valid])
    for f in ("snr_db", "snr_data_db"):
        np.testing.assert_allclose(getattr(ours, f).numpy()[valid],
                                   np.asarray(getattr(ref, f))[valid], atol=1e-3, err_msg=f)
    ce_ok = ours.chan_est_ok.numpy()
    h_ref = _np(ref.chan_est)[ce_ok]
    np.testing.assert_allclose(ours.chan_est.numpy()[ce_ok], h_ref, rtol=0,
                               atol=1e-5 * np.abs(h_ref).max())

    # every placed frame decodes once, with its MCS, type, length and payload
    assert int(valid.sum()) == int(ours.crc_ok.sum()) == len(TRAFFIC)
    slots = np.nonzero(valid)[0][np.argsort(ours.start.numpy()[valid])]
    for slot, (pos, k), payload in zip(slots, placed, payloads):
        mcs, n_bytes, ptype = TRAFFIC[k]
        assert 0 <= int(ours.start[slot]) - pos <= CFG.fft_len
        assert int(ours.mcs[slot]) == int(mcs)
        assert int(ours.packet_type_bit[slot]) == ptype.sig_bit
        assert int(ours.payload_len[slot]) == n_bytes
        np.testing.assert_array_equal(ours.payload[slot, :n_bytes].numpy(), payload)
        assert bool(ours.chan_est_ok[slot]) == (ptype is PacketType.NDP)
    assert int(ce_ok.sum()) == 1
    h = ours.chan_est.numpy()[ce_ok][0]
    assert np.abs(h[CFG.active_carrier_idx]).min() > 0.1  # live on the active carriers

    # the nn.Module runs the same chain from its buffers
    model = tst.StreamingRxDynamic(CFG, BLOCK_LEN, N_BLOCKS, max_frames_per_block=MAX_FRAMES,
                                   max_payload=MAXP, device="cpu")
    res = model(_t(cap))
    for f in res._fields:
        assert torch.equal(getattr(res, f), getattr(ours, f)), f


def test_scan_rx_dynamic_refuses_an_unknown_estimator(mixed_capture):
    """An estimator other than "ls" and "sta" raises. The sequential and the
    windowed branch are held to the reference, and to their module twin, in
    tests/test_torch_block_rx.py::test_scan_rx_dynamic_branches_match_reference."""
    with pytest.raises(ValueError, match="estimator"):
        tst.scan_rx_dynamic(CFG, _dyn_tab(), _t(mixed_capture[0]), BLOCK_LEN, N_BLOCKS,
                            max_payload=MAXP, estimator="mmse")


# ------------------------------------------------------ each row's own extent

EXTENT_T = 160
#: the extents that meet the code's memory (0 … 7) and the envelope's end (T − 7 … T)
EXTENTS = [0, 1, 5, 6, 7, 100] + [EXTENT_T - k for k in range(7, -1, -1)]


def _erased_rows(kind: str, extents, seed: int = 0) -> torch.Tensor:
    """Rows of hard ±1 values (ties everywhere) or soft LLRs with 20%
    erasures, each erased from its extent on."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 1, (len(extents), 2 * EXTENT_T)).astype(np.float32)
    if kind == "hard":
        v = np.sign(v)
    else:
        v[rng.random(v.shape) < 0.2] = 0.0
    for row, n in zip(v, extents):
        row[2 * n :] = 0.0
    return torch.from_numpy(v)


@pytest.mark.parametrize("kind", ["hard", "soft"])
@pytest.mark.parametrize("extent", EXTENTS + ["mixed"])
def test_row_extents_give_the_full_envelope_bits(kind, extent):
    """``viterbi_decode_plain(n_steps=)`` against the full-envelope decode of
    the same rows, bit for bit: eight rows at one extent, or one row at each
    extent in one batch, with batch dimensions and ``n_out`` kept."""
    from jrc_tpu_torch.ops import viterbi

    extents = EXTENTS if extent == "mixed" else [extent] * 8
    v = _erased_rows(kind, extents, seed=0 if extent == "mixed" else 1 + extent)
    trellis = _dyn_tab().trellis
    full = viterbi.viterbi_decode_plain(v, trellis)
    n = torch.tensor(extents)
    assert torch.equal(viterbi.viterbi_decode_plain(v, trellis, n_steps=n), full)
    assert torch.equal(viterbi.viterbi_decode_plain(v.reshape(-1, 1, 2 * EXTENT_T), trellis,
                                                    n_out=EXTENT_T - 6, n_steps=n.reshape(-1, 1)),
                       full.reshape(-1, 1, EXTENT_T)[..., : EXTENT_T - 6])
    if extent != "mixed" and extent + viterbi.TAIL < EXTENT_T:  # the zeros after the extent
        assert not full[:, extent:].any()


def test_a_margin_below_the_codes_memory_would_change_bits(monkeypatch):
    """The test above can fail: cut four steps after each extent instead of
    six, and hard rows, whose ties the first-index argmin and the strict
    compare break differently, decode to other bits."""
    from jrc_tpu_torch.ops import viterbi

    extents = list(range(10, 10 + 64))
    v = _erased_rows("hard", extents, seed=7)
    trellis = _dyn_tab().trellis
    full = viterbi.viterbi_decode_plain(v, trellis)
    monkeypatch.setattr(viterbi, "TAIL", 4)
    assert not torch.equal(viterbi.viterbi_decode_plain(v, trellis, n_steps=torch.tensor(extents)),
                           full)


def _full_envelope(monkeypatch):
    """Route K1 to the full-envelope decode: ``n_steps`` and ``entry`` dropped."""
    from jrc_tpu_torch.ops import viterbi_cuda

    orig = viterbi_cuda.viterbi_decode
    seen = []

    def full(values, trellis, n_out=None, route=None, *, n_steps=None, entry=None):
        seen.append(n_steps)
        return orig(values, trellis, n_out, route)

    monkeypatch.setattr(viterbi_cuda, "viterbi_decode", full)
    return seen


def _mixed_slots(mixed_capture):
    """(the mixed capture behind the history a streamer's next superblock
    holds, its stream's slots)."""
    cap = _t(mixed_capture[0])
    left = tst.left_history_samples(CFG)
    xp = torch.cat([cap[-left:], cap])
    det = sync.detect_frames_stream(CFG, xp, BLOCK_LEN, N_BLOCKS, left, max_frames=MAX_FRAMES)
    return xp, tst._stream_slots(det, left)


def test_rx_frame_dynamic_decodes_each_row_to_its_sig_extent(mixed_capture, monkeypatch):
    """``rx_frame_dynamic`` on every slot of the mixed capture, free slots
    included (their trigger at 0 reads the stream's history, here real
    samples): every ``DynamicFrame`` field equal to the same call with the
    full-envelope decode; the extents K1 got are the rows' SIG
    ``n_data_bits``, most of them short of the envelope."""
    xp, slots = _mixed_slots(mixed_capture)
    assert 0 < int(slots.owned.sum()) < len(slots.owned)  # frames and free slots
    tab = _dyn_tab()
    got = dynamic_rx.rx_frame_dynamic(CFG, tab, xp, slots.trig, slots.cfo, max_payload=MAXP)
    pre = dynamic_rx.rx_frame_dynamic_values(CFG, tab, xp, slots.trig, slots.cfo,
                                             max_payload=MAXP)
    seen = _full_envelope(monkeypatch)
    want = dynamic_rx.rx_frame_dynamic(CFG, tab, xp, slots.trig, slots.cfo, max_payload=MAXP)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    sig_steps, n_steps = seen  # the SIG field's K1 runs every row to T
    assert sig_steps is None
    _, n_bits = dynamic_rx.frame_geometry(tab, pre.mcs, pre.length)
    assert torch.equal(n_steps, n_bits) and torch.equal(pre.n_data_bits, n_bits)
    t = dynamic_rx.max_trellis_bits(MAXP)
    assert int((n_steps + 6 < t).sum()) > len(n_steps) // 2


def test_plain_kernels_stand_in_on_the_counted_dynamic_path(mixed_capture):
    """Under ``registry.plain_kernels`` the dynamic decode of an entry point
    (whose K1 takes ``entry=`` for its count) runs the plain versions and
    gives the wrappers' fields."""
    from jrc_tpu_torch.kernels import registry
    from jrc_tpu_torch.utils import profiling

    xp, slots = _mixed_slots(mixed_capture)
    tab = _dyn_tab()
    try:
        got = dynamic_rx.rx_frame_dynamic(CFG, tab, xp, slots.trig, slots.cfo, max_payload=MAXP,
                                          entry="rx")
        with registry.plain_kernels():
            want = dynamic_rx.rx_frame_dynamic(CFG, tab, xp, slots.trig, slots.cfo,
                                               max_payload=MAXP, entry="rx")
    finally:
        profiling.reset()
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_decode_payload_dynamic_passes_each_rows_extent(monkeypatch):
    """``decode_payload_dynamic`` hands K1 the rows' ``n_data_bits`` under
    their clamped MCS, and its bytes and CRC are those of the full-envelope
    decode."""
    tab = _dyn_tab()
    rng = np.random.default_rng(3)
    z = torch.from_numpy((rng.normal(0, 1, (4, dynamic_rx.max_symbols(MAXP), 48, 2))
                          @ [1, 1j]).astype(np.complex64))
    mcs = torch.tensor([0, 3, 5, 9])
    nbytes = torch.tensor([10, 40, MAXP + 4, 4])
    got = dynamic_rx.decode_payload_dynamic(CFG, tab, z, mcs, nbytes, MAXP)
    seen = _full_envelope(monkeypatch)
    want = dynamic_rx.decode_payload_dynamic(CFG, tab, z, mcs, nbytes, MAXP)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(seen[0], dynamic_rx.frame_geometry(tab, mcs.clamp(0, 5), nbytes)[1])
