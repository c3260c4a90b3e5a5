"""How far the ranks' own work differs, percent: 100 · (the slowest − the
fastest rank's median ms from ``start`` to ``decode`` of the ``mesh`` clock,
halos and decode) / the slowest."""
from jrc_bench.drivers import mesh_stages


def read(obs):
    ms = mesh_stages.rank_ms(obs, "mesh", "start", "decode")
    return None if ms is None or not max(ms) else 100.0 * (max(ms) - min(ms)) / max(ms)
