"""The bench and mixed-traffic captures and the pinned JRC dwells, without jax.

``build_capture`` reproduces ``bench.build_capture`` sample for sample from
the TX frame pinned in ``data/bench_frame_qpsk34_64B.npz`` (written by
``scripts/pin_torch_capture.py``): AWGN at ``snr_db`` from
``numpy.random.default_rng(seed)``, the frame added every ``len(frame) +
gap`` samples from sample 500, and ``halo`` zeros appended.

``build_mixed_capture`` does the same with several frames in turn, such as
the seven of ``data/mixed_frames.npz`` (one DATA frame per MCS and one NDP
frame, after the bench channel and CFO), for the SIG-driven dynamic path.

``JRC_DWELLS`` is the short dwell sequence whose reference results
``data/jrc_dwells.npz`` pins (``scripts/pin_torch_jrc.py``);
``pinned_jrc_dwells`` gives each dwell's inputs, draws and pinned results,
``pinned_step_args`` the ``jrc_step`` arguments that reproduce a dwell,
``step_record`` a step's results in the pinned form and ``jrc_mismatches``
the fields where the two part.

``ANTENNA_CONFIGS`` are the (n_tx, n_rx, n_ltf) that jrc_tpu's
``OFDMConfig`` accepts beside its default; ``config_dwells`` runs a dwell
sequence there (``ENTRY_DWELLS``, the dwell of ``__graft_entry__.py``, or
``SOUNDING_DWELLS``) with the draws of ``config_draws``; ``config_frame``
encodes a frame there with the port for a capture of ``build_capture``.
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from jrc_tpu_torch import tables
from jrc_tpu_torch.config import MCS, OFDMConfig, PacketType
from jrc_tpu_torch.models import comm_link
from jrc_tpu_torch.ops import channel
from jrc_tpu_torch.ops.encoder import FrameSpec, make_payload

FIXTURE = Path(__file__).resolve().parent / "data" / "bench_frame_qpsk34_64B.npz"
MIXED_FIXTURE = Path(__file__).resolve().parent / "data" / "mixed_frames.npz"
JRC_FIXTURE = Path(__file__).resolve().parent / "data" / "jrc_dwells.npz"

#: the JRC scene of the bench and the tests: one target at 12 m, 5 m/s, 25°, RCS 10 m²
JRC_TARGET = (12.0, 5.0, 25.0, 10.0)
JRC_COMM_NOISE_VAR = 1e-4
JRC_DATA = ("QPSK_3_4", 80, "DATA", b"jrc data")
JRC_NDP = ("QPSK_1_2", 24, "NDP", b"")
#: (frame, PRNG key of the reference, jrc_step options), run in order from
#: the initial state with the background frozen (empty: a static echo is not
#: cancelled against itself): the Fourier fallback, a sounding frame,
#: Householder steering per subcarrier from its estimate with radar streams
#: on the null-space antennas, then radar-aided steering
_FROZEN = {"background_record": False}
JRC_DWELLS = (
    (JRC_DATA, 0, _FROZEN),
    (JRC_NDP, 1, _FROZEN),
    (JRC_DATA, 2, dict(_FROZEN, radar_aided=False, phased_steering=False,
                       use_radar_streams=True)),
    (JRC_DATA, 3, _FROZEN),
)
#: the pinned state leaves, in the reference JRCState pytree's leaf order
JRC_STATE_LEAVES = ("chan_est_re", "chan_est_im", "chan_valid", "radar_angle", "radar_valid",
                    "background_re", "background_im", "background_count", "frame_count")


def load_bench_frame():
    """(frame complex64, payload uint8, halo int) of the pinned bench frame."""
    with np.load(FIXTURE) as f:
        return f["frame"], f["payload"], int(f["halo"])


def build_capture(frame: np.ndarray, n_samples: int, gap: int = 2111,
                  snr_db: float = 25.0, seed: int = 0, halo: int = 0):
    """→ (capture complex64 (n_samples + halo,), number of frames placed)."""
    rng = np.random.default_rng(seed)
    noise_var = float(np.mean(np.abs(frame) ** 2)) / 10 ** (snr_db / 10)
    cap = (
        rng.normal(0, np.sqrt(noise_var / 2), (n_samples, 2))
        .view(np.complex128)[:, 0]
    ).astype(np.complex64)
    pos, n_frames = 500, 0
    while pos + len(frame) < n_samples - 100:
        cap[pos : pos + len(frame)] += frame
        pos += len(frame) + gap
        n_frames += 1
    cap = np.concatenate([cap, np.zeros(halo, np.complex64)])
    return cap, n_frames


class MixedFrame(NamedTuple):
    samples: np.ndarray  # complex64 frame after the channel
    payload: np.ndarray  # uint8, payload_bytes long (without CRC)
    mcs: int  # MCS index
    packet_type_bit: int  # 0 = NDP, 1 = DATA


def load_mixed_frames() -> list[MixedFrame]:
    """The seven pinned mixed-traffic frames, in capture order."""
    with np.load(MIXED_FIXTURE) as f:
        return [MixedFrame(f[f"frame_{i}"], f[f"payload_{i}"], int(f["mcs"][i]),
                           int(f["packet_type_bit"][i])) for i in range(len(f["mcs"]))]


def build_mixed_capture(frames, n_samples: int, gap: int = 2111, snr_db: float = 25.0,
                        seed: int = 0, halo: int = 0):
    """Cycle through ``frames`` (complex sample arrays) in order, ``gap``
    samples apart from sample 500, over AWGN at ``snr_db`` relative to the
    frames' mean power → (capture complex64 (n_samples + halo,),
    placements int64 (n_placed, 2) of (start sample, frame index))."""
    rng = np.random.default_rng(seed)
    power = float(np.mean(np.abs(np.concatenate(frames)) ** 2))
    noise_var = power / 10 ** (snr_db / 10)
    cap = (
        rng.normal(0, np.sqrt(noise_var / 2), (n_samples, 2))
        .view(np.complex128)[:, 0]
    ).astype(np.complex64)
    pos, k, placed = 500, 0, []
    while pos + len(frames[k % len(frames)]) < n_samples - 100:
        frame = frames[k % len(frames)]
        cap[pos : pos + len(frame)] += frame
        placed.append((pos, k % len(frames)))
        pos += len(frame) + gap
        k += 1
    cap = np.concatenate([cap, np.zeros(halo, np.complex64)])
    return cap, np.asarray(placed, np.int64).reshape(-1, 2)


def jrc_payload(frame) -> np.ndarray:
    """The uint8 payload of a ``JRC_DWELLS`` frame: its packet-type byte (2
    DATA, 1 NDP) and text, zero-padded to its length."""
    _, n_bytes, ptype, text = frame
    buf = np.zeros(n_bytes, np.uint8)
    data = bytes([2 if ptype == "DATA" else 1]) + text
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    return buf


class PinnedDwell(NamedTuple):
    frame: tuple  # (MCS name, payload bytes, packet type name, text)
    options: dict  # jrc_step options
    payload: np.ndarray  # uint8
    comm_noise: np.ndarray  # complex64 standard normal pairs of the comm leg
    radar_values: np.ndarray | None  # int8 radar-stream values, where the dwell uses them
    want: dict  # the pinned results, keys without the "d<i>_" prefix


def pinned_jrc_dwells() -> list[PinnedDwell]:
    """The ``JRC_DWELLS`` with their pinned draws and reference results."""
    with np.load(JRC_FIXTURE) as f:
        arrays = {k: f[k] for k in f}
    out = []
    for i, (frame, _, options) in enumerate(JRC_DWELLS):
        p = f"d{i}_"
        want = {k[len(p):]: v for k, v in arrays.items() if k.startswith(p)}
        out.append(PinnedDwell(frame, options, want.pop("payload_in"), want.pop("comm_noise"),
                               want.pop("radar_values", None), want))
    return out


def pinned_step_args(dwell, device):
    """(spec, payload, targets, draws, options) of a ``PinnedDwell``
    on ``device``: the inputs of ``jrc_step`` that reproduce it."""
    mcs, n_bytes, ptype, _ = dwell.frame
    spec = FrameSpec(MCS[mcs], payload_bytes=n_bytes, packet_type=PacketType[ptype])
    values = (None if dwell.radar_values is None
              else torch.from_numpy(dwell.radar_values).to(torch.int64).to(device))
    draws = comm_link.Draws(radar_values=values,
                            comm_noise=torch.from_numpy(dwell.comm_noise).to(device))
    targets = channel.Targets(*((v,) for v in JRC_TARGET))
    options = dict(dwell.options, comm_noise_var=JRC_COMM_NOISE_VAR)
    return spec, torch.from_numpy(dwell.payload).to(device), targets, draws, options


def step_record(result) -> dict:
    """One dwell's results as numpy (a host read of each): the radar
    estimate, the map's peak row and column, the decoded frame, SIG fields,
    SNRs, trigger, channel estimates and the new state of a
    ``models.jrc_trx.JRCStepResult`` — the fields ``jrc_mismatches``
    compares."""
    est, eq, dec = result.radar_est, result.comm.eq, result.comm.decoded
    ra = result.ra_map
    rec = {f: getattr(est, f).cpu().numpy() for f in est._fields}
    rec["map_row"] = ra[est.range_idx].cpu().numpy()
    rec["map_col"] = ra[:, est.angle_idx].cpu().numpy()
    rec.update(payload=dec.payload.cpu().numpy(), crc_ok=dec.crc_ok.cpu().numpy(),
               start=result.comm.detection.start.cpu().numpy())
    for f in ("snr_legacy", "snr_data", "sig_rate_bitmap", "sig_length", "sig_ptype", "sig_ok",
              "chan_mean", "chan_est_full"):
        rec[f] = getattr(eq, f).cpu().numpy()
    st = result.state
    rec.update(chan_est=st.chan_est.cpu().numpy(), background=st.background.buffer.cpu().numpy(),
               background_count=st.background.count.cpu().numpy())
    for f in ("chan_valid", "radar_angle", "radar_valid", "frame_count"):
        rec[f] = getattr(st, f).cpu().numpy()
    return rec


#: fields of a dwell record held exactly, in dB, and relative to max|want|
JRC_EXACT = ("detected", "range_idx", "angle_idx", "range_m", "angle_deg", "radar_angle", "payload",
             "crc_ok", "start", "sig_rate_bitmap", "sig_length", "sig_ptype", "sig_ok",
             "chan_valid", "radar_valid", "background_count", "frame_count")
JRC_DB = ("snr_db", "snr_legacy", "snr_data")
JRC_RELATIVE = ("map_row", "map_col", "power", "chan_mean", "chan_est_full", "chan_est",
                "background")


def jrc_record(arrays: dict) -> dict:
    """A pinned dwell's results (``PinnedDwell.want``) in the form of
    ``step_record``: the state's complex leaves joined."""
    rec = {k: v for k, v in arrays.items() if not k.startswith("state_")}
    for name in ("chan_est", "background"):
        rec[name] = arrays[f"state_{name}_re"] + 1j * arrays[f"state_{name}_im"]
    for name in ("chan_valid", "radar_angle", "radar_valid", "background_count", "frame_count"):
        rec[name] = arrays[f"state_{name}"]
    return rec


def jrc_mismatches(got: dict, want: dict, rtol: float = 1e-5, db_tol: float = 1e-3) -> list[str]:
    """The fields where dwell record ``got`` leaves ``want``: exact fields
    unequal, dB fields more than ``db_tol`` apart, the others more than
    ``rtol`` · max|want| apart."""
    bad = []
    for k in JRC_EXACT:
        if not np.array_equal(np.asarray(got[k]), np.asarray(want[k])):
            bad.append(f"{k}: {got[k]} != {want[k]}")
    for k in JRC_DB:  # -inf where nothing was detected
        if not (float(got[k]) == float(want[k]) or abs(float(got[k]) - float(want[k])) <= db_tol):
            bad.append(f"{k}: {got[k]} vs {want[k]} dB")
    for k in JRC_RELATIVE:
        w = np.asarray(want[k])
        err = float(np.abs(np.asarray(got[k]) - w).max())
        if not err <= rtol * max(float(np.abs(w).max()), 1e-30):
            bad.append(f"{k}: max |diff| {err:.3g} > {rtol} * max|want| {np.abs(w).max():.3g}")
    return bad


#: (n_tx, n_rx, n_ltf) of the antenna configurations that jrc_tpu's OFDMConfig
#: accepts beside its default (4, 2, 4): one, two and four TX (n_ltf = n_tx),
#: any n_rx, and three TX over four MIMO-LTFs (the P_ltf rows orthogonal)
ANTENNA_CONFIGS = ((1, 1, 1), (2, 1, 2), (1, 2, 1), (4, 4, 4), (3, 2, 4))
#: the frame and scene of __graft_entry__.py: a 64-B QPSK-3/4 DATA frame, a
#: static target at 12 m and 25° (RCS 10 m²)
ENTRY_FRAME = ("QPSK_3_4", 64, "DATA", b"entry frame")
ENTRY_TARGET = (12.0, 0.0, 25.0, 10.0)
#: dwell sequences of (frame, jrc_step options), each run from the initial
#: state at comm noise variance JRC_COMM_NOISE_VAR. ENTRY_DWELLS: the
#: __graft_entry__.py dwell (radar-aided phased steering) three times, the
#: background recorded. SOUNDING_DWELLS: an NDP frame, then a DATA frame
#: steered per subcarrier from its estimate (Householder) with radar streams
#: on the other antennas, the background frozen
ENTRY_DWELLS = ((ENTRY_FRAME, {}),) * 3
SOUNDING_DWELLS = ((JRC_NDP, _FROZEN), (ENTRY_FRAME, dict(
    _FROZEN, radar_aided=False, phased_steering=False, use_radar_streams=True)))


def antenna_config(n_tx: int, n_rx: int, n_ltf: int) -> OFDMConfig:
    """The default OFDMConfig at an (n_tx, n_rx, n_ltf) of ``ANTENNA_CONFIGS``."""
    return OFDMConfig(n_tx=n_tx, n_rx=n_rx, n_ltf=n_ltf)


def dwell_args(dwell, device):
    """(spec, payload on ``device``, targets, jrc_step options) of a dwell of
    ``ENTRY_DWELLS`` or ``SOUNDING_DWELLS``."""
    frame, options = dwell
    mcs, n_bytes, ptype, _ = frame
    spec = FrameSpec(MCS[mcs], payload_bytes=n_bytes, packet_type=PacketType[ptype])
    return (spec, torch.from_numpy(jrc_payload(frame)).to(device),
            channel.Targets(*((v,) for v in ENTRY_TARGET)),
            dict(options, comm_noise_var=JRC_COMM_NOISE_VAR))


def comm_noise_samples(cfg: OFDMConfig, spec: FrameSpec) -> int:
    """Samples of a jrc_step comm leg: the frame with jrc_step's padding of 5
    and 3 symbols."""
    return (cfg.n_sync_words + 1 + cfg.n_ltf + spec.n_ofdm_sym + 5 + 3) * cfg.sym_len


def config_draws(cfg: OFDMConfig, dwells, rng: np.random.Generator):
    """Seeded draws of a dwell sequence at ``cfg`` → (comm noise: standard
    normal complex64 pairs a dwell, radar-stream values: int64 (n_tx − 1,
    n_sym, n_active) for a dwell with radar streams, else None)."""
    noise, values = [], []
    for dwell in dwells:
        spec, _, _, options = dwell_args(dwell, "cpu")
        n = comm_noise_samples(cfg, spec)
        noise.append(rng.standard_normal((n, 2), np.float32).view(np.complex64)[:, 0])
        values.append(rng.integers(0, 4, (cfg.n_tx - 1, spec.n_ofdm_sym, cfg.n_data_carriers
                                          + cfg.n_pilot_carriers))
                      if options.get("use_radar_streams") else None)
    return noise, values


def config_dwells(trx, dwells, comm_noise, radar_values=None) -> list[dict]:
    """A dwell sequence through ``trx`` (a ``models.jrc_trx.JRCTrx``) from its
    initial state with the given draws (as from ``config_draws``) → each
    dwell's ``step_record``."""
    state, records = trx.init_state(), []
    for i, dwell in enumerate(dwells):
        spec, payload, targets, options = dwell_args(dwell, trx.device)
        values = None if radar_values is None else radar_values[i]
        draws = comm_link.Draws(
            comm_noise=torch.from_numpy(np.asarray(comm_noise[i], np.complex64)).to(trx.device),
            radar_values=None if values is None else torch.as_tensor(
                np.asarray(values, np.int64)).to(trx.device))
        r = trx(state, spec, payload, targets, draws=draws, **options)
        state = r.state
        records.append(step_record(r))
    return records


def config_frame(cfg: OFDMConfig, spec: FrameSpec, text: bytes, device="cpu"):
    """(frame complex64, payload uint8) of ``text`` behind the packet-type
    byte, encoded by the port at ``cfg`` (scrambler seed 1) through the bench
    channel (angle 0, path loss 5, CFO 0.02 cycles per fft_len)."""
    type_byte = bytes([2 if spec.packet_type is PacketType.DATA else 1])
    payload = make_payload(spec, type_byte + text)
    tab = tables.from_numpy(cfg, spec, device)
    tx = comm_link.tx_frame(cfg, spec, tab, torch.from_numpy(payload).to(device), 1)
    frame = channel.comm_channel(tx.samples, angle_deg=0.0, path_loss=5.0,
                                 cfo=0.02 * 2 * np.pi / cfg.fft_len)
    return frame.cpu().numpy().astype(np.complex64), payload
