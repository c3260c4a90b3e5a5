"""Device ms of detection inside the sharded step (stage ``detect`` of the
decode's ``rx`` clock: K2, the suppression over 4 candidates a slot, the
sorts), each rank's median; the largest over the ranks."""
from jrc_bench.drivers import mesh_stages


def read(obs):
    ms = mesh_stages.rank_ms(obs, "rx", "start", "detect")
    return None if ms is None else max(ms)
