"""Device ms of the payload's K1 inside the sharded step (the ``rx`` clock's
``viterbi`` stage, ``ops/viterbi_cuda``), each rank's median; the largest
over the ranks (a rank whose free slots decode a long garbage SIG runs
longest)."""
from jrc_bench.drivers import mesh_stages


def read(obs):
    ms = mesh_stages.rank_ms(obs, "rx", "demap", "viterbi")
    return None if ms is None else max(ms)
