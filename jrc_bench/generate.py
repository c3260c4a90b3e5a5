"""The one traffic generator: what a mix's parameters (``traffic/<mix>.json``)
and ``--seed`` make of the inputs, the same on both sides of a comparison.

Frames are encoded by the plain reference's TX chain (``reference/phy.py``:
encoder, preamble, SIG, MIMO-LTF, OFDM and cyclic prefix), then pass the
bench channel: a ULA phase at 0°, a path loss and a carrier frequency
offset. ``tests/test_bench_encoder.py`` holds that chain against the frames
the JAX package pinned. Payloads and scrambler seeds are drawn with numpy from the
seed; noise is drawn on the run's device with a ``torch.Generator`` seeded
with it, in a few large calls.

An RX capture is the arithmetic of ``capture.build_mixed_capture``: the mix's
frames in turn, from sample ``first``, either ``gap`` samples after the end
of the one before or one every ``every`` samples, over AWGN at ``snr_db``
below the frames' mean power. Its length is a whole number of RX blocks and
its ends are noise only, so pushed round and round it gives every block the
same samples on every pass and no frame straddles the wrap.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from jrc_bench.reference import phy
from jrc_bench.reference.phy import Kind

#: how far a frame's end keeps from the end of the capture (build_mixed_capture's 100)
TAIL_GUARD = 100
#: samples of capture noise drawn in one call
NOISE_CHUNK = 1 << 22


def spec_of(kind) -> Kind:
    """A mix's frame kind ``[mcs name, payload bytes, packet type name]``."""
    mcs, n_bytes, ptype = kind
    return Kind(str(mcs), int(n_bytes), str(ptype))


def rng(seed: int, stream: int) -> np.random.Generator:
    """numpy's generator of one named stream of draws of ``seed``."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def torch_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))


def draw_payload(r: np.random.Generator, spec: Kind) -> np.ndarray:
    """A payload of ``spec``: its packet-type byte (2 DATA, 1 NDP, the UDP PDU
    convention) then random bytes."""
    out = r.integers(0, 256, spec.payload_bytes, dtype=np.uint8)
    out[0] = 2 if spec.ptype == "DATA" else 1
    return out


def tx_frame(spec: Kind, payload: np.ndarray, scrambler_seed: int, *, path_loss: float,
             cfo: float) -> np.ndarray:
    """One frame through the reference TX chain and the bench channel →
    complex64 samples."""
    tx, _ = phy.tx_frame(spec, payload, int(scrambler_seed))
    return phy.comm_channel(tx, 0.0, path_loss, cfo).astype(np.complex64)


class Placed(NamedTuple):
    pos: np.ndarray  # (N,) first sample of each frame in the capture
    kind: np.ndarray  # (N,) index into the mix's frame kinds
    length: np.ndarray  # (N,) samples of each frame
    payload: list  # N uint8 payloads
    specs: list  # the mix's frame Kinds, by kind
    seed: np.ndarray  # (N,) scrambler seed of each frame


class RxCapture(NamedTuple):
    samples: np.ndarray  # (L,) complex64, L a whole number of blocks
    placed: Placed
    noise_var: float
    clean: np.ndarray  # (L,) complex64, the frames without the noise


def rx_capture(mix: dict, seed: int, device) -> RxCapture:
    """The capture of an RX mix for ``seed``: frames drawn and encoded on the
    host, noise drawn on ``device`` in pieces of ``NOISE_CHUNK`` samples, the
    sum on the host."""
    specs = [spec_of(k) for k in mix["frames"]]
    n = int(mix["capture_samples"])
    first = int(mix.get("first", 500))
    r = rng(seed, 1)
    cfo = float(mix["cfo_cycles_per_fft"]) * 2 * np.pi / phy.FFT
    pos, kinds, lengths, payloads, frames, seeds = [], [], [], [], [], []
    p, k = first, 0
    while True:
        kind = k % len(specs)
        spec = specs[kind]
        payload = draw_payload(r, spec)
        s_seed = int(r.integers(1, 128))
        frame = tx_frame(spec, payload, s_seed, path_loss=float(mix["path_loss"]), cfo=cfo)
        if p + len(frame) >= n - TAIL_GUARD:
            break
        pos.append(p)
        kinds.append(kind)
        lengths.append(len(frame))
        payloads.append(payload)
        frames.append(frame)
        seeds.append(s_seed)
        p = first + (k + 1) * int(mix["every"]) if "every" in mix else p + len(frame) + int(mix["gap"])
        k += 1
    if not frames:
        raise ValueError("the mix places no frame in its capture")
    power = float(np.mean(np.abs(np.concatenate(frames[: len(specs)])) ** 2))
    noise_var = power / 10 ** (float(mix["snr_db"]) / 10)
    g = torch_generator(seed, device)
    cap = np.empty(n, np.complex64)
    for lo in range(0, n, NOISE_CHUNK):  # in pieces, so the device holds little of it
        hi = min(n, lo + NOISE_CHUNK)
        noise = torch.randn((hi - lo, 2), generator=g, device=device) * float(np.sqrt(noise_var / 2))
        cap[lo:hi] = torch.view_as_complex(noise).cpu().numpy()
    clean = np.zeros(n, np.complex64)
    for p, frame in zip(pos, frames):
        clean[p : p + len(frame)] = frame
    cap += clean
    placed = Placed(np.asarray(pos, np.int64), np.asarray(kinds, np.int64),
                    np.asarray(lengths, np.int64), payloads, specs, np.asarray(seeds, np.int64))
    return RxCapture(cap, placed, noise_var, clean)


class DwellPools(NamedTuple):
    """The draws a JRC dwell loop cycles through: payloads of each spec and
    the comm leg's noise (standard normal pairs, one row a draw)."""

    payloads: dict  # frame name → (P, payload_bytes) uint8 tensor on the device
    noise: dict  # frame name → (P, n_samples) complex64 tensor on the device


def dwell_samples(spec: Kind) -> int:
    """Samples of a dwell's transmitted burst: 5 symbols of padding, the
    frame, 3 symbols of padding (``jrc_step``'s pads)."""
    return (phy.N_SYNC + 1 + phy.N_LTF + spec.n_sym + 8) * phy.SYM


def dwell_pools(specs: dict, pool: int, seed: int, device) -> DwellPools:
    """``pool`` payloads and noise draws of each of ``specs`` (name → spec),
    from ``seed``: the payloads with numpy, the noise on ``device`` in one
    call a spec."""
    r = rng(seed, 2)
    g = torch_generator(seed, device)
    payloads, noise = {}, {}
    for name, spec in specs.items():
        payloads[name] = torch.from_numpy(
            np.stack([draw_payload(r, spec) for _ in range(pool)])).to(device)
        n = dwell_samples(spec)
        noise[name] = torch.view_as_complex(
            torch.randn((pool, n, 2), generator=g, device=device))
    return DwellPools(payloads, noise)
