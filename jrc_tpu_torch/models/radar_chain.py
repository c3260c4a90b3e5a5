"""Radar-only closed loop: TX frame → target scene → range-angle estimate
(port of jrc_tpu/models/radar_chain.py).

precoder → IFFT/CP → zero_pad → point targets (+AWGN) → CP strip/FFT →
per-(tx,rx,sc) channel estimate → range IFFT → corner turn → angle FFT →
peak detection. The RX window is time-aligned with TX by construction.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from jrc_tpu_torch.config import OFDMConfig
from jrc_tpu_torch.models import comm_link
from jrc_tpu_torch.ops import channel, encoder, ofdm, radar
from jrc_tpu_torch.tables import RadarTables, Tables


class RadarFrameResult(NamedTuple):
    estimate: radar.RangeAngleEstimate
    ra_map: torch.Tensor  # (n_range, n_angle) complex
    chan: torch.Tensor  # (n_virt, fft_len) radar channel estimate
    background: radar.BackgroundState


def image(cfg: OFDMConfig, rtab: RadarTables, h: torch.Tensor, snr_threshold_db: float = 15.0):
    """Channel estimate → (range-angle map, estimate) at ``rtab``'s
    interpolation and tapers."""
    ra = radar.range_angle_map(h, rtab.range_axis.shape[0] // cfg.fft_len,
                               rtab.angle_axis.shape[0] // cfg.n_virtual,
                               taper_range=rtab.taper_range)
    est = radar.range_angle_estimate(ra, rtab.range_axis, rtab.angle_axis,
                                     snr_threshold_db=snr_threshold_db)
    return ra, est


def radar_frame(
    cfg: OFDMConfig,
    spec: encoder.FrameSpec,
    tab: Tables,
    rtab: RadarTables,
    payload: torch.Tensor,
    targets: channel.Targets | channel.TargetArrays,
    *,
    draws: comm_link.Draws = comm_link.Draws(),
    generator: torch.Generator | None = None,
    scrambler_seed: int = 1,
    noise_var: float = 0.0,
    snr_threshold_db: float = 15.0,
    background: radar.BackgroundState | None = None,
    use_radar_streams: bool = False,
    mean_steering: torch.Tensor | None = None,
    self_coupling_db: float | None = None,
    random_phase: bool = False,
    n_pre: int | None = None,
    n_corr_sym: int | None = None,
) -> RadarFrameResult:
    """One radar dwell: TX, propagate, estimate, image, detect. ``n_pre`` /
    ``n_corr_sym`` default to the 5 preamble symbols (4 sync + SIG) and the
    n_ltf MIMO-LTF correlation symbols. Draws: ``draws.radar_values``
    (radar streams), ``draws.phase`` (with ``random_phase``),
    ``draws.radar_noise`` (with ``noise_var`` > 0), else ``generator``.

    Captured, the twin of ``bench.py``'s ``jax.jit(dwell)``: the tables and
    the generator in a ``functools.partial``, the payload, the scene as
    ``TargetArrays`` (``Targets.on``) and ``draws`` as inputs, the generator
    registered, e.g. ``graph.jit(partial(radar_frame, cfg, spec, tab, rtab,
    generator=gen, random_phase=True), generators=(gen,))(payload, arrays)``."""
    if n_pre is None:
        n_pre = cfg.n_sync_words + 1
    if n_corr_sym is None:
        n_corr_sym = cfg.n_ltf
    tx = comm_link.tx_frame(cfg, spec, tab, payload, scrambler_seed,
                            use_radar_streams=use_radar_streams, radar_values=draws.radar_values,
                            generator=generator, mean_steering=mean_steering,
                            pad_front=0, pad_tail=3 * cfg.sym_len)
    dev = payload.device
    phase = None
    if random_phase:
        phase = comm_link.draw(draws.phase, generator, "phase", lambda: channel.uniform_phase(
            len(targets.ranges), generator=generator, device=dev))
    rx = channel.apply_targets(
        tx.samples, targets, sample_rate=cfg.sample_rate, center_freq=cfg.center_freq,
        pos_virtual=rtab.positions, phase=phase, self_coupling_db=self_coupling_db)
    if noise_var > 0:
        rx = channel.awgn(rx, noise_var, noise=comm_link.draw(
            draws.radar_noise, generator, "radar_noise",
            lambda: channel.normal_pair(rx.shape, generator=generator, device=dev)))

    y = ofdm.ofdm_demodulate(cfg, rx, tx.grid.shape[0])  # (n_rx, n_sym, fft_len)
    x_ref = tx.grid.transpose(0, 1)  # (n_tx, n_sym, fft_len)
    sl = slice(n_pre, n_pre + n_corr_sym)
    h = radar.radar_channel_estimate(x_ref[:, sl], y[:, sl])
    if background is not None:
        h, background = radar.background_removal(background, h)
    else:
        background = radar.init_background(8, cfg.n_virtual, cfg.fft_len, device=h.device)
    ra, est = image(cfg, rtab, h, snr_threshold_db)
    return RadarFrameResult(estimate=est, ra_map=ra, chan=h, background=background)

