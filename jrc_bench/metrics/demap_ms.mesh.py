"""Device ms of the demap inside the sharded step (the ``rx`` clock's
``demap`` stage: the six MCS branches and depuncture over every slot),
each rank's median; the largest over the ranks."""
from jrc_bench.drivers import mesh_stages


def read(obs):
    ms = mesh_stages.rank_ms(obs, "rx", "equalize", "demap")
    return None if ms is None else max(ms)
