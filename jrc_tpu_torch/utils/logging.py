"""CSV logging with the reference's file formats (the port's own copy of
jrc_tpu/utils/logging.py:27-169).

* comm log  — ``HH:MM:SS.mmm, CRC, packet_type, snr, snr_data, per`` rows with
  ``NEW RECORD - <date>`` run headers (lib/stream_decoder_impl.cc:243-249,
  384-403)
* radar log — ``time, power, snr, range, angle`` rows
  (lib/range_angle_estimator_impl.cc:255-279); the 5th field is the angle the
  radar-aided precoder consumes (lib/mimo_precoder_impl.cc:939-947)
* chan est  — ``sc_idx:(re,im);(re,im);...`` per subcarrier
  (lib/mimo_ofdm_equalizer_impl.cc:378-416 / parsed at
  lib/mimo_precoder_impl.cc:795-840)
* radar channel capture — the full channel-major (n_tx·n_rx, fft_len)
  complex tensor as CSV (lib/mimo_ofdm_radar_impl.cc:348-387).
* radar capture npz — the same tensor as complex64 under "chan", with any
  metadata beside it (``save_radar_capture``, the reference's fast variant).
"""
from __future__ import annotations

import datetime

import numpy as np
import torch


def _now_hms_ms() -> str:
    now = datetime.datetime.now()
    return now.strftime("%H:%M:%S.") + f"{now.microsecond // 1000:03d}"


def _now_date() -> str:
    return datetime.datetime.now().strftime("%m-%d-%Y %H:%M:%S")


class CsvLog:
    """Append-only CSV log with 'NEW RECORD' run headers."""

    def __init__(self, path: str):
        self.path = path
        self._started = False

    def _ensure_header(self, fh):
        if not self._started:
            fh.write(f"\n NEW RECORD - {_now_date()}\n")
            self._started = True

    def append(self, *fields):
        with open(self.path, "a") as fh:
            self._ensure_header(fh)
            fh.write(_now_hms_ms() + ", \t" + ", \t".join(str(f) for f in fields) + "\n")


class CommLog(CsvLog):
    def log_frame(self, crc_ok: bool, packet_type: int, snr_db: float,
                  snr_data_db: float, per_percent: float):
        self.append(int(crc_ok), packet_type, f"{snr_db:.3f}",
                    f"{snr_data_db:.3f}", f"{per_percent:.3f}")


class RadarLog(CsvLog):
    def log_detection(self, power: float, snr_db: float, range_m: float, angle_deg: float):
        self.append(f"{power:.6g}", f"{snr_db:.3f}", f"{range_m:.3f}", f"{angle_deg:.3f}")

    @staticmethod
    def last_angle(path: str) -> float | None:
        """Parse the last line's 5th field — exactly what the reference
        precoder reads back (lib/mimo_precoder_impl.cc:939-952)."""
        try:
            with open(path) as fh:
                lines = [l for l in fh if "," in l]
            if not lines:
                return None
            return float(lines[-1].rsplit(",", 1)[-1])
        except (OSError, ValueError):
            return None


def write_chan_est_csv(path: str, chan_est: np.ndarray) -> None:
    """(fft_len, n_tx) complex → the reference's chan_est.csv format."""
    with open(path, "w") as fh:
        for sc, row in enumerate(np.asarray(chan_est)):
            cells = ";".join(f"({v.real:.9g},{v.imag:.9g})" for v in row)
            fh.write(f"{sc}:{cells}\n")


def read_chan_est_csv(path: str, fft_len: int, n_tx: int) -> np.ndarray:
    """Parse the reference's chan_est.csv (lib/mimo_precoder_impl.cc:795-840)."""
    out = np.zeros((fft_len, n_tx), np.complex64)
    with open(path) as fh:
        for line in fh:
            if ":" not in line:
                continue
            idx_s, rest = line.split(":", 1)
            try:
                sc = int(idx_s)
            except ValueError:
                continue
            if not 0 <= sc < fft_len:
                continue  # malformed/truncated line: skip, don't wrap or raise
            cells = [c for c in rest.strip().split(";") if c]
            for j, c in enumerate(cells[:n_tx]):
                re, im = c.strip("()\n ").split(",")
                out[sc, j] = complex(float(re), float(im))
    return out


def append_radar_capture_csv(
    path: str, chan: np.ndarray, n_tx: int, n_rx: int,
    timestamp: str | None = None,
) -> None:
    """Append one capture in the reference's radar-channel CSV format
    (lib/mimo_ofdm_radar_impl.cc:357-377, Eigen csv_formatting):

        HH:MM:SS.mmm, N_tx, N_rx, fft_len:(re,im);(re,im);…;(re,im);

    ``chan`` is the (n_tx·n_rx, fft_len) channel-major tensor the radar
    estimator emits — flattened channel-major exactly like the reference's
    ``radar_chan_est`` buffer map.
    """
    chan = np.asarray(chan)
    if chan.shape != (n_tx * n_rx, chan.shape[-1]):
        raise ValueError(
            f"chan must be channel-major (n_tx·n_rx, fft_len); got "
            f"{chan.shape} for n_tx={n_tx}, n_rx={n_rx}")
    fft_len = chan.shape[-1]
    flat = chan.reshape(-1)
    ts = timestamp if timestamp is not None else _now_hms_ms()
    cells = ";".join(f"({v.real:.9g},{v.imag:.9g})" for v in flat)
    with open(path, "a") as fh:
        fh.write(f"{ts}, {n_tx}, {n_rx}, {fft_len}:{cells};\n")


def read_radar_capture_csv(path: str):
    """Parse every capture line of the reference radar-channel CSV back into
    (timestamp, n_tx, n_rx, (n_tx·n_rx, fft_len) complex64) tuples."""
    out = []
    with open(path) as fh:
        for line in fh:
            if "(" not in line or "," not in line:
                continue
            # the header's HH:MM:SS timestamp contains ':' too — the
            # header/data separator is the last ':' before the first '('
            pre = line[: line.index("(")]
            if ":" not in pre:
                continue  # stray chatter line, not a capture record
            head = pre[: pre.rindex(":")]
            rest = line[len(head) + 1 :]
            try:
                ts, n_tx_s, n_rx_s, fft_s = (p.strip() for p in head.split(","))
                n_tx, n_rx, fft_len = int(n_tx_s), int(n_rx_s), int(fft_s)
                cells = [c for c in rest.strip().split(";") if c.strip()]
                vals = np.array(
                    [complex(*(float(p) for p in c.strip("() \n").split(",")))
                     for c in cells], np.complex64,
                )
                out.append((ts, n_tx, n_rx, vals.reshape(n_tx * n_rx, fft_len)))
            except ValueError:
                # malformed header, truncated cell list (reader racing the
                # appender), or wrong cell count — skip the record, keep
                # every parseable one
                continue
    return out


def save_radar_capture(path: str, chan, meta: dict | None = None) -> None:
    """npz capture of the radar channel tensor (fast variant of the
    reference's CSV dump, lib/mimo_ofdm_radar_impl.cc:348-387): ``chan``
    under the key "chan" as complex64 numpy (a tensor is copied to the
    host), ``meta``'s entries under their own keys."""
    if isinstance(chan, torch.Tensor):
        chan = chan.detach().cpu().numpy()
    np.savez_compressed(path, chan=np.asarray(chan, np.complex64), **(meta or {}))
