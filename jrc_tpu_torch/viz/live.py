"""Live (timer-refreshed) plotting (the port's copy of jrc_tpu/viz/live.py,
numpy and matplotlib only) — the reference's GUI sinks' runtime
behavior (lib/gui_heatmap_plot_impl.cc:142-157 + lib/heatmap_plot.cc:130-206,
lib/gui_time_plot_impl.cc:77-103 + lib/time_plot.cc:101-141).

The reference decouples data-rate from display-rate: the work thread copies
each map into a shared buffer under a mutex, and a QTimer redraws whatever is
newest at its own cadence. These classes keep exactly that contract:

* ``push(...)`` is cheap and thread-safe — it overwrites the shared latest
  buffer (maps) or appends to the sliding window (metrics) and never draws;
* ``tick(now)`` redraws only when ``refresh_interval_s`` has elapsed since
  the last draw — pushes in between are coalesced, like QTimer frames;
* each refresh atomically rewrites a PNG, so ``watch -n0.1`` / any image
  viewer that reloads on change becomes the live display (matplotlib runs
  headless on Agg; no GUI event loop is required or used).
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np

from jrc_tpu_torch.viz.heatmap import render_heatmap
from jrc_tpu_torch.viz.timeplot import TimeSeries


class _LiveBase:
    def __init__(self, refresh_interval_s: float = 0.25, path: str | None = None):
        if not path:
            raise ValueError("live views need an output PNG path")
        self.refresh_interval_s = refresh_interval_s
        self.path = path
        self.n_pushed = 0
        self.n_drawn = 0
        self._last_draw = -float("inf")
        self._lock = threading.Lock()
        # serializes _render only: pyplot + the shared tmp file are not
        # thread-safe, and a slow render can outlive its interval — a
        # separate lock keeps push() from ever blocking behind matplotlib
        self._render_lock = threading.Lock()

    def tick(self, now: float | None = None) -> bool:
        """Redraw if the refresh interval has elapsed; returns True when a
        frame was actually drawn (QTimer semantics: data pushes between
        ticks are coalesced into the newest frame). The interval check and
        draw bookkeeping run under the lock so a run() refresh thread and a
        caller's own tick() cannot double-draw one interval."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if now - self._last_draw < self.refresh_interval_s:
                return False
            snap = self._snapshot()  # grabs + clears dirty state, cheap
            if snap is None:
                return False
            # claim the interval inside the lock so a concurrent tick
            # cannot double-draw; the actual render runs OUTSIDE it so
            # push() never blocks behind matplotlib
            self._last_draw = now
            self.n_drawn += 1
        with self._render_lock:
            self._render(snap)
        return True

    def run(self, stop: threading.Event, poll_s: float = 0.02):
        """Refresh loop (the QTimer thread): tick until ``stop`` is set."""
        while not stop.is_set():
            self.tick()
            time.sleep(poll_s)
        self.tick(now=float("inf"))  # final frame

    def _save_atomic(self, fig):
        """Rewrite ``self.path`` atomically so a watching viewer never sees
        a half-written file."""
        tmp = self.path + ".tmp.png"
        fig.savefig(tmp, dpi=110, bbox_inches="tight")
        os.replace(tmp, self.path)

    def _snapshot(self):  # pragma: no cover - overridden
        """Under the lock: return the data to render (clearing dirty
        state), or None when there is nothing new."""
        raise NotImplementedError

    def _render(self, snap) -> None:  # pragma: no cover - overridden
        raise NotImplementedError


class LiveHeatmap(_LiveBase):
    """Timer-refreshed range-angle spectrogram (gui_heatmap_plot)."""

    def __init__(self, range_bins, angle_bins, *, path: str = "live_heatmap.png",
                 refresh_interval_s: float = 0.25, **render_kwargs):
        super().__init__(refresh_interval_s, path)
        self.range_bins = np.asarray(range_bins)
        self.angle_bins = np.asarray(angle_bins)
        self.render_kwargs = render_kwargs
        self._latest: np.ndarray | None = None
        self._dirty = False

    def push(self, ra_map) -> None:
        """Overwrite the shared latest-map buffer (work-thread side,
        lib/gui_heatmap_plot_impl.cc:142-157). ``ra_map`` may be a zero-arg
        callable — it is materialized only when a frame is actually drawn,
        so coalesced pushes never pay a device→host transfer."""
        m = ra_map if callable(ra_map) else np.asarray(ra_map)
        with self._lock:
            self._latest = m
            self._dirty = True
            self.n_pushed += 1

    def _snapshot(self):
        if self._latest is None or not self._dirty:
            return None
        self._dirty = False
        return (self._latest, self.n_pushed)

    def _render(self, snap) -> None:
        import matplotlib.pyplot as plt

        latest, n = snap
        latest = latest() if callable(latest) else latest
        fig = render_heatmap(
            latest, self.range_bins, self.angle_bins,
            title=f"Range-Angle Map (frame {n})",
            **self.render_kwargs,
        )
        self._save_atomic(fig)
        plt.close(fig)


class LiveTimePlot(_LiveBase):
    """Timer-refreshed metric-vs-time scatter (gui_time_plot)."""

    def __init__(self, *, window_s: float = 30.0, path: str = "live_metrics.png",
                 refresh_interval_s: float = 0.25, title: str = "Link metrics"):
        super().__init__(refresh_interval_s, path)
        self.series = TimeSeries(window_s)
        self.title = title
        self._dirty = False

    def push(self, tag: str, t: float, value: float) -> None:
        """Append one stats sample (the reference's ``stats`` message port)."""
        with self._lock:
            self.series.add(tag, t, float(value))
            self._dirty = True
            self.n_pushed += 1

    def _snapshot(self):
        if not self._dirty:
            return None
        self._dirty = False
        # shallow-copy the deques: the render happens outside the lock and
        # must not race concurrent push() appends
        snap = TimeSeries(self.series.window_s)
        snap._data = {k: type(v)(v) for k, v in self.series._data.items()}
        return snap

    def _render(self, snap) -> None:
        import matplotlib.pyplot as plt

        fig = snap.render(title=self.title)
        self._save_atomic(fig)
        plt.close(fig)
