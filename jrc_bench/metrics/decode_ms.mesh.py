"""Device ms of the decode after detection inside the sharded step (the
``rx`` clock's ``extract`` through ``finish``: K3, equalizer and SIG, demap,
K1, descramble and CRC over every slot), each rank's median; the largest
over the ranks."""
from jrc_bench.drivers import mesh_stages


def read(obs):
    ms = mesh_stages.rank_ms(obs, "rx", "detect", "finish")
    return None if ms is None else max(ms)
