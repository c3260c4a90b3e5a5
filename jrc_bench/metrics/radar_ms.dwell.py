"""Device ms a dwell of the stage ``radar`` (estimate, background, map and peak):
the program's stage clock inside the captured step, median over its dwells."""
from jrc_bench.drivers import program_counters as pc


def read(obs):
    return pc.stage_ms("dwell", "radar")
