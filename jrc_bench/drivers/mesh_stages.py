"""The stage clocks of the sharded step on every rank, as the ``.mesh``
per-layer metric readers read them.

``drivers/rx_mesh.py`` hands every rank's complete calls to rank 0 after
the window and keeps them as ``Observed.stage_rows``: one ``{entry: [{stage:
ns}, ...]}`` a rank, in rank order, for the entries ``mesh`` (the sharded
step) and ``rx`` (the decode inside it); and the decode's counts as
``Observed.count_rows``: one ``{name: [(value, envelope), ...]}`` a rank. A
program that does not stamp an entry or write a count, or a run of another
driver, gives None.
"""
from __future__ import annotations

import statistics


def rank_ms(obs, entry: str, first: str, last: str) -> list[float] | None:
    """Each rank's median device ms from stage ``first`` to stage ``last`` of
    ``entry``, in rank order; None where a rank has no complete call."""
    ranks = getattr(obs, "stage_rows", None)
    if not ranks:
        return None
    out = []
    for rows in ranks:
        spans = [(r[last] - r[first]) / 1e6 for r in rows.get(entry, ())
                 if first in r and last in r]
        if not spans:
            return None
        out.append(statistics.median(spans))
    return out


def rank_count_pct(obs, name: str) -> list[float] | None:
    """Each rank's 100 · count ``name`` summed over its calls / their
    envelopes, in rank order; None where a rank has no call counted."""
    ranks = getattr(obs, "count_rows", None)
    if not ranks:
        return None
    out = []
    for counts in ranks:
        rows = counts.get(name) or ()
        if not rows:
            return None
        out.append(100.0 * sum(v for v, _ in rows) / sum(e for _, e in rows))
    return out
