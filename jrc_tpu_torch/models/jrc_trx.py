"""Full JRC transceiver: data transmission and radar sensing at once, the
radar's angle estimate steering the communication precoder (port of
jrc_tpu/models/jrc_trx.py).

The precoder steers DATA frames from the feedback state (radar angle, else
the NDP channel estimate, else the Fourier matrix) while every frame is
also correlated against its own echo to image the scene. The feedback that
the reference passes through files (chan_est.csv, radar_log.csv) is the
explicit ``JRCState``. ``jrc_step`` is one dwell and reads nothing back to
the host: the state's fallbacks are ``torch.where``. ``JRCTrx`` is the
entry point: an ``nn.Module`` holding the constant tables on its device
(the CUDA device unless the caller names another).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from jrc_tpu_torch import tables
from jrc_tpu_torch.config import OFDMConfig, PacketType
from jrc_tpu_torch.models import comm_link
from jrc_tpu_torch.models.radar_chain import image
from jrc_tpu_torch.models.streaming import _entry_device
from jrc_tpu_torch.ops import channel, encoder, equalizer, ofdm, precoder, radar
from jrc_tpu_torch.tables import RadarTables, Tables
from jrc_tpu_torch.utils.profiling import stamp


class JRCState(NamedTuple):
    """Cross-frame feedback state."""

    chan_est: torch.Tensor  # (fft_len, n_tx) complex64 last NDP estimate
    chan_valid: torch.Tensor  # bool
    radar_angle: torch.Tensor  # float32 deg, last detected target angle
    radar_valid: torch.Tensor  # bool
    background: radar.BackgroundState
    frame_count: torch.Tensor  # int32


def init_state(cfg: OFDMConfig, record_len: int = 8, device=None) -> JRCState:
    """A dwell's first state on ``device`` (None: the CUDA device; it raises
    where there is none)."""
    device = _entry_device(device)

    def scalar(dtype):
        return torch.zeros((), dtype=dtype, device=device)

    return JRCState(
        chan_est=torch.zeros((cfg.fft_len, cfg.n_tx), dtype=torch.complex64, device=device),
        chan_valid=scalar(torch.bool), radar_angle=scalar(torch.float32),
        radar_valid=scalar(torch.bool),
        background=radar.init_background(record_len, cfg.n_virtual, cfg.fft_len, device=device),
        frame_count=scalar(torch.int32),
    )


def state_to_numpy(state: JRCState) -> list[np.ndarray]:
    """The state as numpy arrays in the leaf order of the reference's
    ``JRCState`` pytree: chan_est re, im, chan_valid, radar_angle,
    radar_valid, background buffer re, im, background count, frame_count."""
    ce, buf = state.chan_est.cpu().numpy(), state.background.buffer.cpu().numpy()
    return [ce.real, ce.imag, state.chan_valid.cpu().numpy(), state.radar_angle.cpu().numpy(),
            state.radar_valid.cpu().numpy(), buf.real, buf.imag,
            state.background.count.cpu().numpy(), state.frame_count.cpu().numpy()]


def state_from_numpy(leaves, device=None) -> JRCState:
    """A state from numpy arrays in the leaf order of ``state_to_numpy`` (the
    leaves of a reference ``JRCState``, ``jax.tree_util.tree_leaves``) on
    ``device`` (None: the CUDA device; it raises where there is none)."""
    device = _entry_device(device)
    ce_re, ce_im, chan_valid, angle, radar_valid, b_re, b_im, count, frame_count = (
        np.asarray(x) for x in leaves)

    def t(x, dtype):
        return torch.as_tensor(np.array(x)).to(dtype).to(device)

    return JRCState(
        chan_est=t(ce_re + 1j * ce_im, torch.complex64), chan_valid=t(chan_valid, torch.bool),
        radar_angle=t(angle, torch.float32), radar_valid=t(radar_valid, torch.bool),
        background=radar.BackgroundState(buffer=t(b_re + 1j * b_im, torch.complex64),
                                         count=t(count, torch.int32)),
        frame_count=t(frame_count, torch.int32),
    )


def select_steering(cfg: OFDMConfig, tab: Tables, state: JRCState, *, radar_aided: bool,
                    phased_steering: bool, smoothing: bool):
    """(per-subcarrier Q or None, mean Q) with the fallback chain radar angle
    → channel estimate → Fourier. Per-subcarrier steering applies only when
    neither smoothing nor radar-aided."""
    q_dft = tab.fourier
    q_sc, q_mean_chan = precoder.steering_from_chan_est(cfg, tab, state.chan_est,
                                                        phased=phased_steering)
    mean_q = torch.where(state.chan_valid, q_mean_chan, q_dft)
    if radar_aided:
        q_radar = precoder.steering_from_angle(cfg, state.radar_angle, phased=phased_steering)
        return None, torch.where(state.radar_valid, q_radar, mean_q)
    if smoothing:
        return None, mean_q
    return torch.where(state.chan_valid, q_sc, q_dft.expand(q_sc.shape)), mean_q


class JRCStepResult(NamedTuple):
    state: JRCState
    comm: comm_link.RxResult
    radar_est: radar.RangeAngleEstimate
    ra_map: torch.Tensor


def jrc_tx(cfg: OFDMConfig, tab: Tables, state: JRCState, spec: encoder.FrameSpec,
           payload: torch.Tensor, *, radar_values: torch.Tensor | None = None,
           generator: torch.Generator | None = None, radar_aided: bool = True,
           phased_steering: bool = True, smoothing: bool = False,
           use_radar_streams: bool = False, scrambler_seed=1, pad_front: int | None = None,
           pad_tail: int | None = None) -> comm_link.TxFrame:
    """TX side of one dwell: steer DATA frames from the feedback state (NDP
    is never precoded) and build the padded multi-antenna frame."""
    if pad_front is None:
        pad_front = 5 * cfg.sym_len
    if pad_tail is None:
        pad_tail = 3 * cfg.sym_len
    is_data = spec.packet_type is PacketType.DATA
    per_sc, mean_q = (select_steering(cfg, tab, state, radar_aided=radar_aided,
                                      phased_steering=phased_steering, smoothing=smoothing)
                      if is_data else (None, None))
    return comm_link.tx_frame(
        cfg, spec, tab, payload, scrambler_seed, steering=per_sc, mean_steering=mean_q,
        use_radar_streams=use_radar_streams and is_data, radar_values=radar_values,
        generator=generator, pad_front=pad_front, pad_tail=pad_tail)


def jrc_radar_rx(cfg: OFDMConfig, rtab: RadarTables, state: JRCState, tx_grid: torch.Tensor,
                 rx: torch.Tensor, *, background_record=True, snr_threshold_db: float = 15.0):
    """Radar leg of one dwell from a burst that starts at the frame's first
    sample: demodulate, estimate the per-(tx,rx,sc) channel over the
    MIMO-LTF symbols, remove the background, image, detect → (estimate,
    map, new background)."""
    y = ofdm.ofdm_demodulate(cfg, rx, tx_grid.shape[0])
    x_ref = tx_grid.transpose(0, 1)
    n_pre = cfg.n_sync_words + 1
    sl = slice(n_pre, n_pre + cfg.n_ltf)
    h = radar.radar_channel_estimate(x_ref[:, sl], y[:, sl])
    h_clean, background = radar.background_removal(state.background, h, record=background_record)
    ra_map, est = image(cfg, rtab, h_clean, snr_threshold_db)
    return est, ra_map, background


def radar_state_update(state: JRCState, est: radar.RangeAngleEstimate, background) -> JRCState:
    """Fold a dwell's detection into the feedback state."""
    return state._replace(
        radar_angle=torch.where(est.detected, est.angle_deg, state.radar_angle),
        radar_valid=state.radar_valid | est.detected,
        background=background,
        frame_count=state.frame_count + 1,
    )


def jrc_step(
    cfg: OFDMConfig,
    tab: Tables,
    rtab: RadarTables,
    state: JRCState,
    spec: encoder.FrameSpec,
    payload: torch.Tensor,
    targets: channel.Targets | channel.TargetArrays,
    *,
    draws: comm_link.Draws = comm_link.Draws(),
    generator: torch.Generator | None = None,
    radar_aided: bool = True,
    phased_steering: bool = True,
    smoothing: bool = False,
    use_radar_streams: bool = False,
    background_record=True,
    comm_angle_deg: float | None = None,
    comm_path_loss: float = 20.0,
    comm_snr_db: float = 25.0,
    comm_noise_var: float | None = None,  # absolute noise (overrides comm_snr_db)
    radar_noise_var: float = 0.0,
    scrambler_seed=1,
    snr_threshold_db: float = 15.0,
) -> JRCStepResult:
    """One JRC dwell: steer → TX → (echo → radar update) ∥ (comm RX → decode).
    For DATA frames the radar angle (or channel estimate) steers the
    precoder; an NDP frame whose SIG decodes refreshes ``state.chan_est``.
    ``comm_angle_deg`` defaults to the first target's azimuth (with
    ``TargetArrays``, a 0-d tensor on the device). Draws come from ``draws``
    (``radar_values``, ``radar_noise``, ``comm_noise``), else from
    ``generator``. The dwell stamps its stages on the stage clock of
    ``utils.profiling`` (entry ``"dwell"``): ``tx``, ``channel`` (both
    channels and their noise), ``radar`` (estimate, background, map, peak)
    and ``comm_rx`` (the comm RX chain and the state update).

    Captured, the twin of ``bench.py``'s ``jax.jit(loop_step)``: the module
    ``JRCTrx`` through ``graph.jit(trx, generators=(trx.generator,))``, called
    with the state (carried from dwell to dwell: one graph), the spec, the
    payload and the scene as ``TargetArrays`` (``Targets.on``, made once),
    the floats (``comm_noise_var``, ``comm_angle_deg``) fixed at capture as
    part of the signature. A ``Targets`` of host values raises there
    (``channel.to_device``)."""
    if comm_angle_deg is None:
        comm_angle_deg = targets.azimuths[0]
    stamp("dwell", "start", payload)
    dev = payload.device
    pad_front = 5 * cfg.sym_len
    is_data = spec.packet_type is PacketType.DATA
    radar_values = draws.radar_values
    if use_radar_streams and is_data:
        radar_values = comm_link.draw(radar_values, generator, "radar_values", lambda: (
            precoder.radar_stream_values(cfg, spec.n_ofdm_sym, generator=generator, device=dev)))
    tx = jrc_tx(cfg, tab, state, spec, payload, radar_values=radar_values,
                radar_aided=radar_aided, phased_steering=phased_steering, smoothing=smoothing,
                use_radar_streams=use_radar_streams, scrambler_seed=scrambler_seed,
                pad_front=pad_front, pad_tail=3 * cfg.sym_len)
    n = tx.samples.shape[-1]
    stamp("dwell", "tx", payload)

    # both channels, the radar's draw first: the time-aligned echo of this very
    # frame, and a ULA receiver at the target vehicle's angle
    echo = channel.apply_targets(tx.samples, targets, sample_rate=cfg.sample_rate,
                                 center_freq=cfg.center_freq, pos_virtual=rtab.positions)
    if radar_noise_var > 0:
        echo = channel.awgn(echo, radar_noise_var, noise=comm_link.draw(
            draws.radar_noise, generator, "radar_noise",
            lambda: channel.normal_pair((cfg.n_rx, n), generator=generator, device=dev)))
    rx_wave = channel.comm_channel(tx.samples, angle_deg=comm_angle_deg,
                                   path_loss=comm_path_loss)
    if comm_noise_var is None:
        nv = equalizer.abs2(rx_wave).mean() / 10.0 ** (comm_snr_db / 10.0)
    else:
        nv = comm_noise_var
    rx_wave = channel.awgn(rx_wave, nv, noise=comm_link.draw(
        draws.comm_noise, generator, "comm_noise",
        lambda: channel.normal_pair((n,), generator=generator, device=dev)))
    stamp("dwell", "channel", payload)

    # radar leg, front padding dropped
    est, ra_map, background = jrc_radar_rx(cfg, rtab, state, tx.grid, echo[..., pad_front:],
                                           background_record=background_record,
                                           snr_threshold_db=snr_threshold_db)
    stamp("dwell", "radar", payload)

    # comm leg
    comm = comm_link.rx_chain(cfg, spec, tab, comm_link.guard(cfg, rx_wave))

    # state update (the reference's CSV writes)
    new_state = radar_state_update(state, est, background)
    if not is_data:
        upd = comm.eq.sig_ok
        new_state = new_state._replace(
            chan_est=torch.where(upd, comm.eq.chan_est_full, state.chan_est),
            chan_valid=state.chan_valid | upd)
    stamp("dwell", "comm_rx", payload)
    return JRCStepResult(state=new_state, comm=comm, radar_est=est, ra_map=ra_map)


class JRCTrx(nn.Module):
    """The JRC transceiver as a module. It holds the radar tables (virtual
    positions, range and angle axes, tapers) as buffers and builds the
    per-spec ``Tables`` (sync words, LTF mapping, SIG symbols, constellation,
    trellis, CRC and scrambler tables) on its device at a spec's first use;
    its generator (seeded with ``seed``) draws what ``draws`` leaves out.
    ``forward(state, spec, payload, targets, **kw)`` is ``jrc_step``."""

    def __init__(self, cfg: OFDMConfig, *, interp_factor_range: int = 8,
                 interp_factor_angle: int = 16, window_range: str | None = None,
                 record_len: int = 8, seed: int = 0, device=None):
        super().__init__()
        dev = _entry_device(device)
        self.cfg, self.record_len = cfg, record_len
        rtab = tables.radar_from_numpy(cfg, dev, interp_factor_range, interp_factor_angle,
                                       window_range)
        for name, t in rtab._asdict().items():
            self.register_buffer(name, t)
        self._tables: dict = {}
        self.generator = torch.Generator(device=dev).manual_seed(seed)

    @property
    def device(self) -> torch.device:
        return self.range_axis.device

    def radar_tables(self) -> RadarTables:
        return RadarTables(**{f: getattr(self, f) for f in RadarTables._fields})

    def tables(self, spec: encoder.FrameSpec) -> Tables:
        if spec not in self._tables:
            self._tables[spec] = tables.from_numpy(self.cfg, spec, self.device)
        return self._tables[spec]

    def init_state(self) -> JRCState:
        return init_state(self.cfg, self.record_len, device=self.device)

    def check_device(self, *xs) -> None:
        for x in xs:
            if x.device != self.device:
                raise RuntimeError(f"JRCTrx lies on {self.device} but its input on {x.device}; "
                                   "move the input to the module's device")

    def forward(self, state: JRCState, spec: encoder.FrameSpec, payload: torch.Tensor,
                targets: channel.Targets | channel.TargetArrays, *,
                draws: comm_link.Draws = comm_link.Draws(),
                **kw) -> JRCStepResult:
        self.check_device(payload, state.chan_est)
        return jrc_step(self.cfg, self.tables(spec), self.radar_tables(), state, spec, payload,
                        targets, draws=draws, generator=self.generator, **kw)
