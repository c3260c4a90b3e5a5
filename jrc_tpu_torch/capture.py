"""The bench capture without jax (numpy only).

``build_capture`` reproduces ``bench.build_capture`` sample for sample from
the TX frame pinned in ``data/bench_frame_qpsk34_64B.npz`` (written by
``scripts/pin_torch_capture.py``): AWGN at ``snr_db`` from
``numpy.random.default_rng(seed)``, the frame added every ``len(frame) +
gap`` samples from sample 500, and ``halo`` zeros appended.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

FIXTURE = Path(__file__).resolve().parent / "data" / "bench_frame_qpsk34_64B.npz"


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
