"""Synthetic channels: the point-target radar scene and the comm-sim
channel (port of jrc_tpu/ops/channel.py).

Radar model per target k and virtual element (tx, rx):
  Doppler   f_D = 2·v·f_c/c, a time-domain phase ramp;
  delay     τ = (2R − pos_virt·sin(az))/c, applied as exp(−j2πτ(f+f_c)) over
            the two-sided FFT bin frequencies of the whole frame;
  amplitude A = c·√RCS / ((4π)^{3/2}·R²·f_c);
  optionally a random phase per target and TX→RX self-coupling.
Target contributions are summed (the reference's superposition).

Everything is float32 in the reference's association order: the delay
phase reaches about 1.2e4 rad at 12 m and 24 GHz, where one float32 ulp is
about 1e-3 rad, so a float64 phase would be a different result, and so
would τ divided by c as a host scalar on the card (a product with the
reciprocal there). The frame transforms are ``torch.fft`` (the reference: a
Cooley-Tukey matmul DFT).

Random draws (per-target phase, AWGN) go through ``uniform_phase`` and
``normal_pair``, which take a ``torch.Generator``; every function that
draws also takes the draws as a tensor instead.

A scene is a ``Targets`` of host values, or its ``TargetArrays`` (``Targets.on``):
float32 tensors on the device, made once, which a captured dwell
(``utils.graph.jit``) takes as an input. ``apply_targets`` uploads a
``Targets`` on every call, which a capture cannot hold (a copy node would
read a host buffer freed after the capture), so there it raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from jrc_tpu_torch.config import C_LIGHT

FOUR_PI_CUBED_SQRT = float((4 * np.pi) ** 1.5)


@dataclass(frozen=True)
class Targets:
    """Static point-target scene (ranges m, velocities m/s, azimuths deg, RCS m²)."""

    ranges: tuple
    velocities: tuple
    azimuths: tuple
    rcs: tuple

    def __len__(self):
        return len(self.ranges)

    def on(self, device) -> "TargetArrays":
        """The scene as float32 tensors on ``device``, uploaded now."""
        return TargetArrays(*(to_device(v, device) for v in (
            self.ranges, self.velocities, self.azimuths, self.rcs, _sin_az(self.azimuths))))


def _sin_az(azimuths) -> torch.Tensor:
    # sin(az) on the host, whatever the device: the delay phase multiplies it by about
    # 2π·f_c·pos/c, so one ulp of another device's sinf would move the echo by 1e-3 rad
    return torch.sin(torch.deg2rad(torch.tensor(azimuths, dtype=torch.float32)))


class TargetArrays(NamedTuple):
    """A ``Targets`` scene on a device (``Targets.on``): (K,) float32 tensors,
    sin(azimuth) computed on the host as ``apply_targets`` computes it."""

    ranges: torch.Tensor
    velocities: torch.Tensor
    azimuths: torch.Tensor
    rcs: torch.Tensor
    sin_az: torch.Tensor


def virtual_positions(n_tx: int, n_rx: int, wavelength: float, spacing: float = 0.5) -> np.ndarray:
    """(n_tx, n_rx) float32 positions in meters of the λ/2 virtual ULA: the
    rx-major pair index rx·n_tx + tx walks the array linearly."""
    tx = np.arange(n_tx)[:, None]
    rx = np.arange(n_rx)[None, :]
    return ((rx * n_tx + tx) * spacing * wavelength).astype(np.float32)


def to_device(values, device) -> torch.Tensor:
    """float32 tensor of host ``values`` (a sequence or a CPU tensor) on
    ``device`` without a host sync (a non-blocking copy from pinned memory
    to a CUDA device). Inside a CUDA graph capture it raises: the copy node
    would read the temporary pinned buffer again on every replay."""
    t = torch.as_tensor(values, dtype=torch.float32)
    if torch.device(device).type != "cuda":
        return t.to(device)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("host values uploaded inside a CUDA graph capture; give the scene "
                           "as device tensors (channel.Targets.on(device))")
    return t.pin_memory().to(device, non_blocking=True)


def uniform_phase(k: int, *, generator=None, device=None) -> torch.Tensor:
    """(k,) float32 phases uniform in [0, 2π)."""
    return 2 * math.pi * torch.rand(k, generator=generator, device=device)


def normal_pair(shape, *, generator=None, device=None) -> torch.Tensor:
    """Complex64 draws whose real and imaginary parts are independent
    standard normals."""
    return torch.view_as_complex(torch.randn((*shape, 2), generator=generator, device=device))


def _expj(theta: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.cos(theta), torch.sin(theta))


def apply_targets(
    tx_time: torch.Tensor,  # (n_tx, n_samp) complex64
    targets: Targets | TargetArrays,
    *,
    sample_rate: float,
    center_freq: float,
    pos_virtual: torch.Tensor,  # (n_tx, n_rx) float32 meters
    phase: torch.Tensor | None = None,  # (K,) per-target phases (``uniform_phase``)
    self_coupling_db: float | None = None,
    t0: float = 0.0,
) -> torch.Tensor:
    """Propagate the TX waveforms through the scene → (n_rx, n_samp), with
    a phase per target where ``phase`` is given. ``t0`` is the stream time
    of the first sample: the Doppler ramp continues across successive
    calls."""
    dev = tx_time.device
    n = tx_time.shape[-1]
    if isinstance(targets, TargetArrays):
        rng_t, vel, rcs, sin_az = targets.ranges, targets.velocities, targets.rcs, targets.sin_az
    else:
        rng_t, vel, rcs, sin_az = (to_device(v, dev) for v in (
            targets.ranges, targets.velocities, targets.rcs, _sin_az(targets.azimuths)))

    doppler = 2.0 * vel * center_freq / C_LIGHT
    ampl = C_LIGHT * torch.sqrt(rcs) / FOUR_PI_CUBED_SQRT / rng_t**2 / center_freq
    t = float(np.float32(t0)) + torch.arange(n, dtype=torch.float32, device=dev) / sample_rate
    ramp = _expj(2 * math.pi * doppler[:, None] * t[None, :])  # (K, n)
    if phase is not None:
        ramp = ramp * _expj(phase)[:, None]
    ramp = ramp * ampl[:, None]

    x = torch.fft.fft(tx_time[:, None, :] * ramp[None])  # (n_tx, K, n)
    freqs = torch.fft.fftfreq(n, 1.0 / sample_rate, dtype=torch.float64,
                              device=dev).to(torch.float32)
    # divided by a tensor on the device: CUDA turns a division by a host scalar into a product
    # with its reciprocal, which moves τ by an ulp and the delay phase by about 1e-3 rad
    c_light = torch.full((), C_LIGHT, dtype=torch.float32, device=dev)
    tau = (2.0 * rng_t[None, None, :] - pos_virtual[:, :, None] * sin_az[None, None, :]) / c_light
    shift = _expj(-2 * math.pi * tau[..., None] * (freqs + center_freq))  # (n_tx, n_rx, K, n)
    y = torch.fft.ifft(x[:, None] * shift)
    rx = y.sum(dim=(0, 2))
    if self_coupling_db is not None:
        rx = rx + 10.0 ** (self_coupling_db / 20.0) * tx_time.sum(0)[None, :]
    return rx


def awgn(x: torch.Tensor, noise_var, *, noise: torch.Tensor | None = None,
         generator: torch.Generator | None = None) -> torch.Tensor:
    """x plus complex AWGN of total variance ``noise_var`` (a float or a 0-d
    float32 tensor; noise_var/2 a quadrature): ``noise`` (standard normal
    pairs shaped like x, see ``normal_pair``), else drawn from ``generator``."""
    if noise is None:
        noise = normal_pair(x.shape, generator=generator, device=x.device)
    if isinstance(noise_var, torch.Tensor):
        std = torch.sqrt(noise_var.to(torch.float32) / 2.0)
    else:  # in float32 on the host: no copy to the device
        std = float(np.sqrt(np.float32(noise_var) / np.float32(2.0)))
    return x + torch.complex(std * noise.real, std * noise.imag)


def thermal_noise_var(sample_rate: float, noise_figure_db: float = 5.0,
                      temp_k: float = 290.0) -> float:
    """kTB·NF noise variance of the sim flowgraphs."""
    k_boltz = 1.380649e-23
    return k_boltz * temp_k * sample_rate * 10.0 ** (noise_figure_db / 10.0)


def comm_channel(
    tx_time: torch.Tensor,  # (n_tx, n_samp) complex64
    *,
    angle_deg,  # a float, or a 0-d float32 tensor on the waveform's device
    path_loss: float,
    noise_var: float = 0.0,
    cfo: float = 0.0,  # rad/sample
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """ULA phase exp(jπ·sin θ·k) per TX antenna, path loss, sum over the
    antennas and CFO rotation → (n_samp,). As the reference adds AWGN only
    where it is given a key, ``awgn`` of total variance ``noise_var`` is
    added only where ``noise`` (standard normal pairs, (n_samp,)) or a
    ``generator`` is given and ``noise_var`` > 0."""
    dev = tx_time.device
    n_tx, n = tx_time.shape
    angle = (angle_deg.to(torch.float32) if isinstance(angle_deg, torch.Tensor)
             else torch.full((), angle_deg, dtype=torch.float32, device=dev))
    k = torch.arange(n_tx, device=dev)
    steer = _expj(torch.pi * torch.sin(torch.deg2rad(angle)) * k)
    y = (tx_time * steer[:, None]).sum(0) / path_loss
    if cfo:
        y = y * _expj(cfo * torch.arange(n, dtype=torch.float32, device=dev))
    if (noise is not None or generator is not None) and noise_var > 0:
        y = awgn(y, noise_var, noise=noise, generator=generator)
    return y
