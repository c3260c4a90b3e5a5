"""The plain reference of the JRC transceiver's dwell, in numpy float64.

One dwell of the testbed's JRC loop (Ozkaptan et al., TWC 2023) written from
its semantics: the DATA frame steered from the feedback state (the radar
angle, else the NDP channel estimate, else the Fourier precoder; an NDP is
never precoded), the point target's echo on the 4 × 2 virtual array, the
radar channel over the MIMO-LTFs, the background (the mean of the last
``record_len`` estimates) taken off, the zero-padded range-angle map, its
peak and SNR, and the comm leg: the frame through the ULA channel and the
given noise into the receiver of ``phy``. ``state`` is a plain dict.
Nothing here imports the program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from jrc_bench.reference import phy
from jrc_bench.reference.phy import FFT, N_RX, N_SYNC, N_TX, SYM, Kind, Prec

C = 299792458.0
PAD_FRONT, PAD_TAIL = 5 * SYM, 3 * SYM


class Radar(NamedTuple):
    """The map's axes: range bins (m) and angle bins (deg) as the testbed's
    flowgraph lays them out, in float32."""

    ranges: np.ndarray
    angles: np.ndarray
    positions: np.ndarray  # (n_tx, n_rx) virtual-element positions, m


def radar_axes(ir: int, ia: int) -> Radar:
    n_ang = N_TX * N_RX * ia
    k = np.arange(n_ang)
    lam = C / phy.FC
    pos = (np.arange(N_RX)[None, :] * N_TX + np.arange(N_TX)[:, None]) * 0.5 * lam
    return Radar(np.linspace(0, C * FFT / (2 * phy.FS), FFT * ir).astype(np.float32),
                 np.degrees(np.arcsin(np.clip(2 / n_ang * (k - n_ang / 2), -1, 1))).astype(
                     np.float32), pos)


def init_state(record_len: int) -> dict:
    return {"chan_est": np.zeros((FFT, N_TX), np.complex128), "chan_valid": False,
            "radar_angle": 0.0, "radar_valid": False,
            "buffer": np.zeros((record_len, N_TX * N_RX, FFT), np.complex128), "count": 0,
            "frame_count": 0}


def phased(h: np.ndarray) -> np.ndarray:
    """Phased steering toward a channel row h: column 0 is conj(h) scaled to
    √n_tx / ‖h‖, the other streams off."""
    q = np.zeros((N_TX, N_TX), np.complex128)
    q[:, 0] = np.conj(h) * np.sqrt(N_TX) / np.linalg.norm(h)
    return q


def steering(state: dict) -> np.ndarray:
    if state["radar_valid"]:
        return phased(np.exp(1j * np.pi * np.sin(np.deg2rad(state["radar_angle"]))
                             * np.arange(N_TX)))
    if state["chan_valid"]:
        return phased(state["chan_est"][phy.ACTIVE_SC].mean(0))
    return phy.fourier()


def echo(tx: np.ndarray, target: tuple, ax: Radar, prec: Prec) -> np.ndarray:
    """The point target's echo (range m, velocity 0, azimuth deg, RCS m²) at
    each RX antenna: the radar equation's amplitude and, per virtual
    element, the delay (2R − pos·sin az)/c as a phase across the whole
    burst's spectrum at f + fc."""
    rng, _vel, az, rcs = target
    n = tx.shape[-1]
    amp = C * np.sqrt(rcs) / (4 * np.pi) ** 1.5 / rng**2 / phy.FC
    tau = (2 * rng - ax.positions * np.sin(np.deg2rad(az))) / C  # (tx, rx)
    f = np.fft.fftfreq(n, 1 / phy.FS)
    spec = np.fft.fft(tx * amp, axis=-1)  # (tx, n)
    y = np.fft.ifft(spec[:, None] * np.exp(-2j * np.pi * tau[..., None] * (f + phy.FC)), axis=-1)
    return prec.r(y.sum(0))


class Estimate(NamedTuple):
    detected: bool
    range_idx: int
    angle_idx: int
    angle_deg: float


def estimate(m: np.ndarray, ax: Radar, threshold_db: float) -> Estimate:
    """The map's strongest cell and its SNR against the mean power of a patch
    half the range axis away at the angle 90° off (2.4 m by 29°, both axes
    wrapped)."""
    nr, na = m.shape
    pw = np.abs(m) ** 2
    ri, ai = divmod(int(np.argmax(pw)), na)
    null = float(ax.angles[ai]) + 90.0
    null = null - 180.0 if null >= 90.0 else null
    ni = min(int(np.argmin(np.abs(ax.angles.astype(np.float64) - null))), na - 2)
    dr = np.float32(ax.ranges[1] - ax.ranges[0])
    da = np.float32(ax.angles[ni + 1] - ax.angles[ni])
    wr = max(int(np.float32(2.4) / dr), 1)
    wa = max(int(np.float32(29.0) / da), 1)
    r = np.abs((np.arange(nr) - (ri + nr // 2) + nr // 2) % nr - nr // 2) < wr
    a = np.abs((np.arange(na) - ni + na // 2) % na - na // 2) < wa
    noise = pw[np.ix_(r, a)].mean()
    snr = 10 * np.log10(pw[ri, ai] / max(noise, 1e-30))
    return Estimate(bool(snr >= threshold_db), ri, ai, float(ax.angles[ai]))


class Dwell(NamedTuple):
    state: dict
    comm: phy.Frame
    est: Estimate
    ra_map: np.ndarray


def dwell(state: dict, kind: Kind, payload: np.ndarray, noise: np.ndarray, target: tuple,
          ax: Radar, *, noise_var: float, threshold_db: float, path_loss: float = 20.0,
          prec: Prec = Prec(), decode: bool = True, fault: str | None = None) -> Dwell:
    """One dwell from ``state``: ``noise`` holds the comm leg's standard normal
    pairs (complex, one a sample of the padded burst). Without ``decode`` the
    comm leg's payload is left undecoded; ``fault="range_flip"`` (a fault
    the control plants) takes the range transform forward instead of
    inverse."""
    q = steering(state) if kind.ptype == "DATA" else None
    tx, grid = phy.tx_frame(kind, payload, 1, q, prec)
    tx = np.concatenate([np.zeros((N_TX, PAD_FRONT)), tx, np.zeros((N_TX, PAD_TAIL))], axis=1)
    # radar: the echo of this frame, its MIMO-LTF symbols against those sent
    rx = echo(tx, target, ax, prec)[:, PAD_FRONT:]
    n_sym = grid.shape[0]
    y = rx[:, : n_sym * SYM].reshape(N_RX, n_sym, SYM)[..., phy.CP:]
    y = prec.r(np.fft.fftshift(np.fft.fft(y, axis=-1, norm="ortho"), axes=-1))
    ltf = slice(N_SYNC + 1, N_SYNC + 1 + phy.N_LTF)
    h = np.einsum("rsf,stf->rtf", y[:, ltf], np.conj(grid[ltf])).reshape(N_RX * N_TX, FFT)
    n_valid = min(state["count"], len(state["buffer"]))
    clean = h - state["buffer"].sum(0) / n_valid if n_valid else h
    buf = state["buffer"].copy()
    buf[state["count"] % len(buf)] = h
    ir = len(ax.ranges) // FFT
    ia = len(ax.angles) // (N_TX * N_RX)
    ra = (np.fft.fft if fault == "range_flip" else np.fft.ifft)(clean, n=FFT * ir, axis=-1).T
    ra_map = prec.r(np.fft.fftshift(np.fft.fft(ra, n=N_TX * N_RX * ia, axis=-1), axes=-1))
    est = estimate(ra_map, ax, threshold_db)
    # comm: a one-antenna receiver at the target's azimuth, the burst and a guard of zeros
    w = phy.comm_channel(tx, target[2], path_loss) + np.sqrt(noise_var / 2) * noise
    w = np.concatenate([w, np.zeros(2 * N_SYNC * SYM)])
    trig, coarse = phy.triggers(prec.r(w))
    t0, c0 = (int(trig[0]), float(coarse[0])) if len(trig) else (0, 0.0)
    comm = phy.receive(prec.r(w), t0, c0, kind.payload_bytes, kind=kind, prec=prec,
                       decode=decode)
    new = dict(state, buffer=buf, count=state["count"] + 1,
               frame_count=state["frame_count"] + 1)
    if est.detected:
        new.update(radar_angle=est.angle_deg, radar_valid=True)
    if kind.ptype == "NDP" and comm.sig_ok:
        new.update(chan_est=comm.chan_est, chan_valid=True)
    return Dwell(new, comm, est, ra_map)
