"""The recordings a sharded cell decodes: ``files`` distinct captures of a
mix, each a whole recording of the configuration's ``step_samples``, made
by the one generator (``generate.rx_capture``) from a seed of its own that
``--seed`` gives. A file is built as one capture, so no frame crosses its
end; its frames' positions follow from the mix alone (``first``, ``gap``
and the frame kinds' lengths), the same for every seed.

The ranks cut a file into equal blocks in time; ``crossing`` names the
frames that cross an inner boundary between two ranks' blocks.
"""
from __future__ import annotations

import numpy as np

from jrc_bench import generate


def file_seed(seed: int, i: int) -> int:
    """The generator's seed of file ``i`` of a run's ``seed``."""
    return int(generate.rng(seed, 10 + i).integers(2**62))


def recordings(mix: dict, n_samples: int, seed: int, device) -> list[generate.RxCapture]:
    """The mix's ``files`` recordings of ``n_samples`` samples each for ``seed``."""
    one = {**mix, "capture_samples": n_samples}
    return [generate.rx_capture(one, file_seed(seed, i), device) for i in range(int(mix["files"]))]


def crossing(cap: generate.RxCapture, ranks: int) -> dict[int, np.ndarray]:
    """Inner boundary (its sample) → the indices of the frames that start
    before it and end after it, for a file cut into ``ranks`` blocks."""
    placed, n = cap.placed, len(cap.samples)
    block = n // ranks
    return {b: np.nonzero((placed.pos < b) & (placed.pos + placed.length > b))[0]
            for b in range(block, n, block)}
