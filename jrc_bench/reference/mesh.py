"""The plain reference of the time-sharded receiver's semantics, in PyTorch
on the CPU in float64 / complex128; the frame's own PHY is ``phy.py``'s.
Nothing here imports the program.

A file of ``n`` samples is cut into ``ranks`` equal blocks in time. Rank
``r`` sees its block with the ``LEFT_HIST`` samples before it and the
``halo`` samples after it (``window``), zeros beyond the file's ends. It
triggers over its whole window (``phy.triggers``) and owns the triggers that
lie inside its block, so a frame that crosses a boundary is decoded once,
by the rank its trigger falls in, from the samples its neighbour handed it.
A frame's global start is its block's first sample plus the trigger's place
in the block (``starts``); the frames' total is the count of every rank's
owned triggers.

Two faults of the sharding, planted for the comparison's control:
``halo_dropped`` (each rank's right halo zeroed, so a frame across a
boundary decodes from zeros) and ``owner_shift`` (each rank's owned span
widened by ``WIDEN`` samples on both sides, so a trigger that near a
boundary is owned twice).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from jrc_bench.reference import phy

#: samples of history before a block: the trigger chain's lookback,
#: 2·(2·SYM − 1) + 1.5·FFT/2 − 1 = 365, rounded up to the detector's 128-sample segments
LEFT_HIST = 384
#: how far ``owner_shift`` widens the owned span on each side
WIDEN = 40
FAULTS = ("halo_dropped", "owner_shift")


def window(x: torch.Tensor, r: int, ranks: int, halo: int, *,
           fault: str | None = None) -> torch.Tensor:
    """Rank ``r``'s samples: ``[LEFT_HIST | its block | halo]`` of the file
    ``x``, zeros beyond its ends (and in the halo under ``halo_dropped``)."""
    n = x.shape[-1]
    block = n // ranks
    lo, hi = r * block - LEFT_HIST, (r + 1) * block + halo
    out = torch.zeros(hi - lo, dtype=torch.complex128)
    a, b = max(lo, 0), min(hi, n)
    out[a - lo : b - lo] = x[a:b].to(torch.complex128)
    if fault == "halo_dropped":
        out[LEFT_HIST + block :] = 0
    return out


class Owned(NamedTuple):
    rank: int
    trig: int  # the trigger's index in the rank's window
    coarse: float  # its coarse CFO, rad/sample
    start: int  # its global start: the rank's first sample plus its place in the block


def owned(w: torch.Tensor, r: int, block: int, *, fault: str | None = None) -> list[Owned]:
    """The triggers rank ``r`` owns over its window ``w``, in order."""
    trig, coarse = phy.triggers(w.numpy())
    widen = WIDEN if fault == "owner_shift" else 0
    keep = (trig >= LEFT_HIST - widen) & (trig < LEFT_HIST + block + widen)
    return [Owned(r, int(t), float(c), r * block + int(t) - LEFT_HIST)
            for t, c in zip(trig[keep], coarse[keep])]


def receive(w: torch.Tensor, o: Owned, max_payload: int, *,
            prec: phy.Prec = phy.Prec()) -> dict:
    """The frame of trigger ``o`` decoded from its rank's window ``w`` → a slot
    record (the fields the program reports, ``start`` global)."""
    fr = phy.receive(w.numpy(), o.trig, o.coarse, max_payload, prec=prec)
    return {"rank": o.rank, "start": o.start, "mcs": fr.mcs, "packet_type_bit": fr.ptype_bit,
            "payload_len": fr.length - 4, "crc_ok": fr.crc_ok, "sig_ok": fr.sig_ok,
            "chan_est_ok": fr.chan_est_ok, "snr_db": fr.snr_db, "snr_data_db": fr.snr_data_db,
            "chan_est": fr.chan_est, "payload": fr.payload}


def starts(x: torch.Tensor, ranks: int, halo: int, *, fault: str | None = None) -> np.ndarray:
    """The global start of every trigger any rank owns, ascending."""
    block = x.shape[-1] // ranks
    return np.sort(np.asarray([o.start for r in range(ranks)
                               for o in owned(window(x, r, ranks, halo, fault=fault), r, block,
                                              fault=fault)], np.int64))


def decode(x: torch.Tensor, ranks: int, halo: int, max_payload: int, *,
           keep: Callable[[int], bool] = lambda start: True, prec: phy.Prec = phy.Prec(),
           fault: str | None = None) -> list[dict]:
    """Every owned frame whose global start ``keep`` accepts, decoded by its
    rank → slot records, rank by rank. ``prec`` rounds each window before its
    triggers, and the receiver's stages, as the control asks."""
    block = x.shape[-1] // ranks
    out = []
    for r in range(ranks):
        w = torch.from_numpy(np.asarray(prec.r(window(x, r, ranks, halo, fault=fault).numpy()),
                                        np.complex128))
        out += [receive(w, o, max_payload, prec=prec)
                for o in owned(w, r, block, fault=fault) if keep(o.start)]
    return out
