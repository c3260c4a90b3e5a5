"""Range-angle heatmap rendering (the port's copy of jrc_tpu/viz/heatmap.py,
numpy and matplotlib only) — offline equivalent of ``gui_heatmap_plot``
(lib/heatmap_plot.cc, lib/range_angle_raster_data.cc).

The QWT spectrogram with its 13-stop colormap and bilinear resampling over
non-uniform angle bins becomes a matplotlib pcolormesh over the true
(non-uniform) arcsin angle grid — no resampling needed.
"""
from __future__ import annotations

import numpy as np


def render_heatmap(
    ra_map,
    range_bins,
    angle_bins,
    *,
    db_floor: float = -50.0,
    db_ceil: float = 10.0,
    max_range_m: float | None = 32.0,
    title: str = "Range-Angle Map",
    xlabel: str = "Angle (deg)",
    ylabel: str = "Range (m)",
    path: str | None = None,
):
    """Render |map|² in dB over (angle, range) axes; returns the figure.

    ``ra_map``: (n_range, n_angle) complex or power, numpy (a tensor goes
    through ``.cpu().numpy()`` first). With ``path`` set the figure is saved
    and closed (headless operation). matplotlib is imported here, at the
    first render, not with the module.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = np.asarray(ra_map)
    power = np.abs(m) ** 2 if np.iscomplexobj(m) else np.asarray(m, float)
    db = 10.0 * np.log10(np.maximum(power, 1e-30))
    db -= db.max()

    rb = np.asarray(range_bins)
    ab = np.asarray(angle_bins)
    if max_range_m is not None:
        keep = rb <= max_range_m
        rb, db = rb[keep], db[keep]

    fig, ax = plt.subplots(figsize=(8, 5))
    pm = ax.pcolormesh(ab, rb, db, cmap="viridis", vmin=db_floor, vmax=db_ceil,
                       shading="nearest")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    fig.colorbar(pm, ax=ax, label="Power (dB)")
    if path is not None:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig
