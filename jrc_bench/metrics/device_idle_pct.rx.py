"""The device's idle share of the window, percent: 1 − the window's calls
times the median device ms of a call (the program's event pair around each
captured call, no profiler) over the window."""
from jrc_bench.drivers import program_counters as pc


def read(obs):
    return pc.device_idle_pct(obs, "rx")
