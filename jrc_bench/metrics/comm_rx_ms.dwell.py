"""Device ms a dwell of the stage ``comm_rx`` (the comm RX chain with its K1 and
the state update): the program's stage clock inside the captured step, median
over its dwells."""
from jrc_bench.drivers import program_counters as pc


def read(obs):
    return pc.stage_ms("dwell", "comm_rx")
