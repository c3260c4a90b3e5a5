"""Metric-vs-time scatter (the port's copy of jrc_tpu/viz/timeplot.py, numpy
and matplotlib only) — offline equivalent of ``gui_time_plot``
(lib/time_plot.cc:101-141): SNR/PER/range/angle values in a sliding window."""
from __future__ import annotations

from collections import deque

import numpy as np


class TimeSeries:
    """Sliding-window store of (t, value) per metric tag, like the reference's
    message-driven scatter."""

    def __init__(self, window_s: float = 30.0):
        self.window_s = window_s
        self._data: dict[str, deque] = {}

    def add(self, tag: str, t: float, value: float):
        dq = self._data.setdefault(tag, deque())
        dq.append((t, value))
        while dq and dq[0][0] < t - self.window_s:
            dq.popleft()

    def render(self, path: str | None = None, title: str = "Link metrics"):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 4))
        for tag, dq in self._data.items():
            if not dq:
                continue
            arr = np.asarray(dq)
            ax.scatter(arr[:, 0], arr[:, 1], s=12, label=tag)
        ax.set_xlabel("Time (s)")
        ax.legend(loc="best")
        ax.set_title(title)
        ax.grid(True, alpha=0.3)
        if path is not None:
            fig.savefig(path, dpi=120, bbox_inches="tight")
            plt.close(fig)
        return fig
