"""Device ms of the sharded step's all-reduce of the totals and all-gathers
of the per-slot fields (stage ``collect`` of ``mesh``), each rank's median;
the smallest over the ranks: the last rank to arrive waits on no one, so
its stage is the collectives' own time."""
from jrc_bench.drivers import mesh_stages


def read(obs):
    ms = mesh_stages.rank_ms(obs, "mesh", "decode", "collect")
    return None if ms is None else min(ms)
