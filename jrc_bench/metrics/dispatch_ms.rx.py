"""Host ms a call of the captured call (``utils/graph``): the program's
``graph.replay`` span (input copy, replay, output clones), median over its
calls."""
from jrc_bench.drivers import program_counters as pc


def read(obs):
    return pc.host_ms("graph.replay")
