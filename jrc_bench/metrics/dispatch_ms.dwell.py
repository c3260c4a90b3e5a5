"""Host ms a dwell of the captured step (``utils/graph``): the program's
``graph.replay`` span (state and input copies, replay, output clones),
median over its dwells."""
from jrc_bench.drivers import program_counters as pc


def read(obs):
    return pc.host_ms("graph.replay")
