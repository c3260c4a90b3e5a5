"""The bench and mixed-traffic captures without jax (numpy only).

``build_capture`` reproduces ``bench.build_capture`` sample for sample from
the TX frame pinned in ``data/bench_frame_qpsk34_64B.npz`` (written by
``scripts/pin_torch_capture.py``): AWGN at ``snr_db`` from
``numpy.random.default_rng(seed)``, the frame added every ``len(frame) +
gap`` samples from sample 500, and ``halo`` zeros appended.

``build_mixed_capture`` does the same with several frames in turn, such as
the seven of ``data/mixed_frames.npz`` (one DATA frame per MCS and one NDP
frame, after the bench channel and CFO), for the SIG-driven dynamic path.
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np

FIXTURE = Path(__file__).resolve().parent / "data" / "bench_frame_qpsk34_64B.npz"
MIXED_FIXTURE = Path(__file__).resolve().parent / "data" / "mixed_frames.npz"


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
