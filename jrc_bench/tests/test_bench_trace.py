"""The trace reduction's interval arithmetic: device-busy time is the union
of the operations' intervals, and each idle gap between the fences is put
down to the operation that ended it."""
from jrc_bench import trace


def test_union_of_overlapping_intervals():
    assert trace._union_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


def test_gaps_between_fences():
    events = [{"ts": 2, "dur": 3, "name": "a"}, {"ts": 4, "dur": 2, "name": "b"},
              {"ts": 9, "dur": 1, "name": "c"}]
    assert trace._gaps(events, 0, 12) == [(0, 2, "a"), (6, 9, "c"),
                                          (10, 12, "the closing fence")]


def test_short_names():
    assert trace.short("void k<int>(int)") == "k<int>(int)"
    assert len(trace.short("x" * 300)) == 120
