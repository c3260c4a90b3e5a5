"""Device ms a dwell of the stage ``channel`` (the echo, the comm channel and
their noise): the program's stage clock inside the captured step, median over
its dwells."""
from jrc_bench.drivers import program_counters as pc


def read(obs):
    return pc.stage_ms("dwell", "channel")
