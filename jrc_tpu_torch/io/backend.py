"""TRX backends: the framework's hardware boundary (port of
jrc_tpu/io/backend.py).

The reference talks to two Ettus N320s through ``usrp_mimo_trx``
(lib/usrp_mimo_trx_impl.cc): timed 4-channel TX bursts + scheduled 2-channel
RX with a fixed TX→RX latency (``num_delay_samps``), which time-aligns the RX
frame with the TX frame — the property the radar correlator relies on.

Here that contract is an abstract interface with two software backends:
:class:`SimTrx` loops the TX frame through the synthetic radar scene
(``ops/channel``) on the CUDA device unless told otherwise, and :class:`FileTrx`
replays/records interleaved complex64 or sc16 IQ captures, for offline
processing of real recordings.

A hardware backend would implement the same ``burst()`` contract against a
radio front end; the DSP chain above it is unchanged.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class BurstResult:
    """RX samples time-aligned to the TX frame start (delay compensated)."""

    rx: np.ndarray  # (n_rx, n_samples); SimTrx: a tensor on its device
    rx_time: float  # capture timestamp (s)


class TrxBackend(abc.ABC):
    """Timed burst TX + aligned RX (the usrp_mimo_trx work() contract:
    lib/usrp_mimo_trx_impl.cc:287-388)."""

    @abc.abstractmethod
    def burst(self, tx_samples: np.ndarray, n_rx_samples: int | None = None) -> BurstResult | None:
        """TX + scheduled RX; ``None`` models an RX deadline miss
        (lib/usrp_mimo_trx_impl.cc:488-494 — the frame is skipped)."""

    def transmit(self, tx_samples: np.ndarray) -> None:
        """TX-only frame (no RX capture) — what the reference sends between
        ``update_period`` bursts (lib/usrp_mimo_trx_impl.cc:357-369)."""

    def close(self):
        pass


class TrxSession:
    """The reference work-loop cadence around any :class:`TrxBackend`
    (lib/usrp_mimo_trx_impl.cc:287-388):

    * a TX+RX **burst** runs at most once per ``update_period`` (25 Hz at
      the TRX flowgraph's 0.04 s); frames arriving in between are
      transmitted **TX-only** with no RX capture (…:357-369);
    * burst RX is re-aligned to the TX frame start by dropping
      ``num_delay_samps`` leading samples — the calibrated TX→RX hardware
      latency (…:374-383);
    * a backend ``None`` (RX deadline miss) skips the frame: the caller
      gets no capture and the loop simply continues (…:488-494).
    """

    def __init__(
        self,
        backend: TrxBackend,
        *,
        update_period: float = 0.04,
        num_delay_samps: int = 0,
        sample_rate: float | None = None,
    ):
        self.backend = backend
        self.update_period = update_period
        self.num_delay_samps = num_delay_samps
        # for the rx_time shift of the alignment strip; defaults to the
        # backend's configured rate when it exposes one
        cfg = getattr(backend, "cfg", None)
        self.sample_rate = sample_rate or getattr(cfg, "sample_rate", None)
        if num_delay_samps > 0 and not self.sample_rate:
            import warnings

            warnings.warn(
                "TrxSession: num_delay_samps > 0 but no sample_rate is "
                "available — rx_time cannot be shifted for the stripped "
                "alignment samples, biasing cross-dwell timestamps",
                stacklevel=2,
            )
        self._prev_tx_time = -float("inf")
        self.n_bursts = 0
        self.n_tx_only = 0
        self.n_missed = 0

    def frame(self, tx_samples: np.ndarray, now: float,
              n_rx_samples: int | None = None) -> BurstResult | None:
        """Send one frame at wall/stream time ``now``; returns the aligned
        RX capture when this frame opened a dwell burst, else None."""
        if now < self._prev_tx_time + self.update_period:
            self.backend.transmit(tx_samples)
            self.n_tx_only += 1
            return None
        self._prev_tx_time = now
        d = self.num_delay_samps
        n_want = n_rx_samples if n_rx_samples is not None else tx_samples.shape[-1]
        res = self.backend.burst(tx_samples, n_want + d)
        if res is None:
            self.n_missed += 1
            return None
        self.n_bursts += 1
        # the aligned capture starts d samples after the raw one — shift the
        # timestamp with it so cross-dwell alignment stays unbiased
        t_shift = d / self.sample_rate if self.sample_rate else 0.0
        return BurstResult(
            rx=res.rx[..., d : d + n_want], rx_time=res.rx_time + t_shift)


class SimTrx(TrxBackend):
    """Loopback through the synthetic radar scene on ``device``: the CUDA
    device unless the caller names another (without one that raises). The
    TX frame is a complex (n_tx, n) tensor on that device or a numpy array,
    which is taken there; a tensor on another device is refused. The capture
    is a tensor on the same device.

    ``hw_delay_samps`` models the calibrated TX→RX latency: the capture
    starts that many samples before the echo (zeros in front), which
    ``TrxSession.num_delay_samps`` must compensate. ``miss_bursts`` are
    burst ordinals whose RX deadline is missed (burst → None). With
    ``noise_var`` > 0, AWGN drawn from a generator seeded with ``seed``.
    """

    def __init__(self, cfg, targets=None, *, noise_var: float = 0.0, seed: int = 0,
                 self_coupling_db: float | None = None, hw_delay_samps: int = 0,
                 miss_bursts=(), device=None):
        from jrc_tpu_torch.models.streaming import _entry_device
        from jrc_tpu_torch.ops import channel

        self.cfg = cfg
        self.targets = targets
        self.noise_var = noise_var
        self.self_coupling_db = self_coupling_db
        self.hw_delay_samps = hw_delay_samps
        self.miss_bursts = set(miss_bursts)
        self.device = _entry_device(device)
        self._burst_idx = 0
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._channel = channel
        self._pos = torch.as_tensor(
            channel.virtual_positions(cfg.n_tx, cfg.n_rx, channel.C_LIGHT / cfg.center_freq)
        ).to(self.device)
        self._t = 0.0

    def burst(self, tx_samples, n_rx_samples: int | None = None) -> BurstResult | None:
        idx = self._burst_idx
        self._burst_idx += 1
        if idx in self.miss_bursts:  # RX deadline miss: frame skipped
            self._t += tx_samples.shape[-1] / self.cfg.sample_rate
            return None
        ch, cfg = self._channel, self.cfg
        if isinstance(tx_samples, torch.Tensor) and tx_samples.device != self.device:
            raise RuntimeError(f"SimTrx lies on {self.device} but its TX frame on "
                               f"{tx_samples.device}; move the frame to the backend's device")
        tx = torch.as_tensor(tx_samples, device=self.device)
        if self.targets is not None:
            rx = ch.apply_targets(
                tx, self.targets, sample_rate=cfg.sample_rate, center_freq=cfg.center_freq,
                pos_virtual=self._pos, self_coupling_db=self.self_coupling_db,
                t0=self._t)  # stream-continuous Doppler phase across bursts
        else:
            rx = torch.zeros((cfg.n_rx, tx.shape[-1]), dtype=torch.complex64, device=self.device)
        if self.noise_var > 0:
            rx = ch.awgn(rx, self.noise_var, generator=self._generator)
        t = self._t
        self._t += tx.shape[-1] / cfg.sample_rate
        rx = torch.nn.functional.pad(rx, (self.hw_delay_samps, 0))
        if n_rx_samples is not None:
            rx = torch.nn.functional.pad(rx, (0, max(0, n_rx_samples - rx.shape[-1])))
            rx = rx[:, :n_rx_samples]
        return BurstResult(rx=rx, rx_time=t)

    def transmit(self, tx_samples) -> None:
        """TX-only frame: the scene hears it, no RX capture is scheduled."""
        self._t += tx_samples.shape[-1] / self.cfg.sample_rate


class FileTrx(TrxBackend):
    """Record TX bursts and replay RX captures from IQ files.

    ``fmt="fc32"`` (default) is the reference's complex64 host format;
    ``fmt="sc16"`` reads/writes interleaved int16 (re, im) — UHD's native
    OTW format, half the bytes — with the standard ±1.0 ↔ ±32767 scaling.
    """

    def __init__(self, cfg, rx_path: str | None = None, tx_path: str | None = None,
                 fmt: str = "fc32"):
        if fmt not in ("fc32", "sc16"):
            raise ValueError(f"fmt must be 'fc32' or 'sc16', got {fmt!r}")
        self.cfg = cfg
        self.rx_path = rx_path
        self.tx_path = tx_path
        self.fmt = fmt
        self._rx_data = None
        self._pos = 0
        if rx_path is not None:
            if fmt == "sc16":
                q = np.fromfile(rx_path, np.int16).astype(np.float32) / 32767.0
                flat = (q[0::2] + 1j * q[1::2]).astype(np.complex64)
            else:
                flat = np.fromfile(rx_path, np.complex64)
            self._rx_data = flat.reshape(cfg.n_rx, -1, order="F") if flat.size else None
        self._t = 0.0

    def _write(self, fh, samples: np.ndarray) -> None:
        # channel-interleaved on disk (column-major, like the replay reshape)
        x = np.ascontiguousarray(np.asarray(samples, np.complex64).T)
        if self.fmt == "sc16":
            q = np.clip(np.rint(x.view(np.float32) * 32767.0),
                        -32767, 32767).astype(np.int16)
            q.tofile(fh)
        else:
            x.tofile(fh)

    def burst(self, tx_samples: np.ndarray, n_rx_samples: int | None = None) -> BurstResult:
        # `is not None`, not falsy-or: an explicit 0-sample RX request must
        # not silently become a tx-length capture (SimTrx semantics)
        n = n_rx_samples if n_rx_samples is not None else tx_samples.shape[-1]
        if self.tx_path is not None:
            with open(self.tx_path, "ab") as fh:
                self._write(fh, tx_samples)
        if self._rx_data is None:
            rx = np.zeros((self.cfg.n_rx, n), np.complex64)
        else:
            end = min(self._pos + n, self._rx_data.shape[1])
            rx = np.zeros((self.cfg.n_rx, n), np.complex64)
            rx[:, : end - self._pos] = self._rx_data[:, self._pos : end]
            self._pos = end
        t = self._t
        self._t += n / self.cfg.sample_rate
        return BurstResult(rx=rx, rx_time=t)

    def transmit(self, tx_samples: np.ndarray) -> None:
        """TX-only frames are still recorded (the reference transmits them)."""
        if self.tx_path is not None:
            with open(self.tx_path, "ab") as fh:
                self._write(fh, tx_samples)
        self._t += tx_samples.shape[-1] / self.cfg.sample_rate
