"""Device ms a call of the rx stage ``viterbi`` (the payload's K1, ``ops/viterbi_cuda``):
the program's stage clock inside the captured call, median over its calls."""
from jrc_bench.drivers import program_counters as pc


def read(obs):
    return pc.stage_ms("rx", "viterbi")
