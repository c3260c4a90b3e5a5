"""Useful decode work against the work done, percent: the frames the
program found over the slots it decoded (every call decodes all of its
slots through every MCS branch), from its counters."""
from jrc_bench.drivers import program_counters as pc


def read(obs):
    return pc.slots_used_pct("rx")
