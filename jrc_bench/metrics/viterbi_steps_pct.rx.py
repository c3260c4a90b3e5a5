"""The share of the envelope that the payload K1's critical path ran, percent:
100 · the longest row's trellis steps summed over the rx calls, over the
calls times the envelope's T, from the program's ``viterbi_steps`` count
(written by K1 on the device, a call at a time); None on a program without
the count."""
from jrc_bench.drivers import program_counters as pc


def read(obs):
    counts = pc._fn("counts")
    rows = counts("rx", "viterbi_steps") if counts is not None else []
    if not rows:
        return None
    return 100.0 * sum(steps for steps, _ in rows) / sum(t for _, t in rows)
