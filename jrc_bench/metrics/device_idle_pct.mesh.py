"""Rank 0's device idle share of the window, percent: 1 − the window's steps
times the median ms from the first to the last ``mesh`` stamp of a step
(``start`` to ``collect``, no profiler, no launch inside) over the window."""
from jrc_bench.drivers import mesh_stages


def read(obs):
    ms = mesh_stages.rank_ms(obs, "mesh", "start", "collect")
    if ms is None or not obs.calls or not obs.seconds:
        return None
    return 100.0 * (1.0 - obs.calls * ms[0] / 1e3 / obs.seconds)
