"""Device ms of the sharded step's halo exchange (stage ``halo`` of
``mesh``: the neighbours' heads and tails, ``batch_isend_irecv``, and the
wait for the slower neighbour), each rank's median; the largest over the
ranks."""
from jrc_bench.drivers import mesh_stages


def read(obs):
    ms = mesh_stages.rank_ms(obs, "mesh", "start", "halo")
    return None if ms is None else max(ms)
