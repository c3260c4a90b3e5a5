"""Checkpoint and resume of the JRC loop's cross-frame state (port of
jrc_tpu/utils/state_io.py).

A snapshot is the reference's npz layout: ``n_leaves``, ``treedef`` (a
description; the reference writes its pytree's and reads neither) and
``leaf_0`` ... ``leaf_{n-1}`` in the leaf order of the reference's
``JRCState`` pytree (``models.jrc_trx.state_to_numpy``). So a snapshot
written by jrc_tpu loads here through ``state_from_numpy``, and one written
here loads into jrc_tpu.
"""
from __future__ import annotations

import numpy as np

from jrc_tpu_torch.models import jrc_trx

TREEDEF = "JRCState leaves: " + ", ".join(
    ("chan_est.re", "chan_est.im", "chan_valid", "radar_angle", "radar_valid",
     "background.buffer.re", "background.buffer.im", "background.count", "frame_count"))


def save_state(path: str, state: jrc_trx.JRCState) -> None:
    """Write ``state`` to an npz snapshot."""
    leaves = jrc_trx.state_to_numpy(state)
    np.savez_compressed(path, n_leaves=len(leaves), treedef=TREEDEF,
                        **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})


def load_state(path: str, like: jrc_trx.JRCState) -> jrc_trx.JRCState:
    """A snapshot as a ``JRCState`` on the device of ``like`` (a state of the
    same configuration, as the reference's ``like`` gives the structure)."""
    with np.load(path, allow_pickle=False) as data:
        n = int(data["n_leaves"])
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    state = jrc_trx.state_from_numpy(leaves, device=like.chan_est.device)
    for got, want in zip(jrc_trx.state_to_numpy(state), jrc_trx.state_to_numpy(like)):
        if got.shape != want.shape:
            raise ValueError(f"snapshot {path}: a leaf of shape {got.shape} where the state has "
                             f"{want.shape}")
    return state
