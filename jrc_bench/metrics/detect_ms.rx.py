"""Device ms a call of the rx stage ``detect`` (K2, the suppression and the
sorts): the program's stage clock inside the captured call, median over its
calls."""
from jrc_bench.drivers import program_counters as pc


def read(obs):
    return pc.stage_ms("rx", "detect")
