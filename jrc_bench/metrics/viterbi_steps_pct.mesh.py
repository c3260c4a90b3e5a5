"""The share of the envelope that the payload K1's critical path ran inside
the sharded step, percent: each rank's 100 · the longest row's trellis steps
summed over its calls, over its calls times the envelope's T (the program's
``viterbi_steps`` count); the largest over the ranks."""
from jrc_bench.drivers import mesh_stages


def read(obs):
    pct = mesh_stages.rank_count_pct(obs, "viterbi_steps")
    return None if pct is None else max(pct)
