"""Link characterization: Monte-Carlo BER/PER curves through the full chain
(port of jrc_tpu/models/evaluation.py).

The TX waveform and its noise-free comm-channel output are built once;
each SNR point adds ``n_frames`` noise realizations and decodes them as one
batch (``comm_link.rx_chain_batch``: one K2 launch, two K3 launches and one
K1 launch for the payloads a point), where the reference vmaps its
per-frame loop. The noise is standard normal pairs, given as one
(n_frames, n) block per point or drawn from a seeded ``torch.Generator``
(``point_inputs``). On a card ``link_curve`` runs its points as one captured
CUDA graph (``utils.graph.jit``), as the reference ``jax.jit``s its vmapped
point: captured at the first point, replayed for the rest.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from jrc_tpu_torch.config import OFDMConfig
from jrc_tpu_torch.models import comm_link
from jrc_tpu_torch.ops import channel, equalizer
from jrc_tpu_torch.ops.encoder import FrameSpec
from jrc_tpu_torch.tables import Tables
from jrc_tpu_torch.utils import graph

class LinkPoint(NamedTuple):
    snr_db: float
    ber: float
    per: float
    n_frames: int


def coding_bit_errors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-byte popcount of a XOR b (bit errors between byte arrays), int32,
    by shifts on the inputs' device (no table copied to it)."""
    x = torch.bitwise_xor(a.to(torch.uint8), b.to(torch.uint8)).to(torch.int32)
    cnt = x & 1
    for k in range(1, 8):
        cnt = cnt + ((x >> k) & 1)
    return cnt


class PointResult(NamedTuple):
    """Per-frame outcome of one SNR point."""

    bit_errors: torch.Tensor  # (n_frames,) int64 bit errors of each frame's payload
    crc_ok: torch.Tensor  # (n_frames,) bool


def clean_waveform(cfg: OFDMConfig, spec: FrameSpec, tab: Tables, payload: torch.Tensor, *,
                   angle_deg: float = 0.0, path_loss: float = 10.0,
                   cfo: float = 0.0) -> torch.Tensor:
    """The noise-free received frame (n,) the curve adds noise to: the TX
    frame padded as ``comm_link.loopback`` pads it, through the comm channel."""
    front, tail, extra = comm_link.LOOPBACK_PAD
    tx = comm_link.tx_frame(cfg, spec, tab, payload, 1, pad_front=front * cfg.sym_len,
                            pad_tail=tail * cfg.sym_len + extra)
    return channel.comm_channel(tx.samples, angle_deg=angle_deg, path_loss=path_loss, cfo=cfo)


def point_inputs(clean: torch.Tensor, snr_db: float, n_frames: int, seed: int, *,
                 sig_pow: float | None = None,
                 noise: torch.Tensor | None = None) -> tuple[float, torch.Tensor]:
    """(noise variance, noise) of one SNR point on ``clean``: the variance is
    the clean frame's mean power (``sig_pow``, else read to the host as a
    float) over 10^(snr/10), rounded to float32 as the reference does; the
    noise is ``noise`` where given, else (n_frames, n) standard normal pairs
    from a generator seeded with ``seed`` on clean's device."""
    if sig_pow is None:
        sig_pow = float(equalizer.abs2(clean).mean())
    nv = float(np.float32(sig_pow / 10.0 ** (snr_db / 10.0)))
    dev = clean.device
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        noise = channel.normal_pair((n_frames, clean.shape[-1]), generator=gen, device=dev)
    return nv, noise.to(dev)


def link_point(cfg: OFDMConfig, spec: FrameSpec, tab: Tables, payload: torch.Tensor,
               clean: torch.Tensor, noise_var, noise: torch.Tensor, *,
               estimator: str = "ls", soft: bool = False) -> PointResult:
    """``noise`` (n_frames, n) standard normal pairs at total variance
    ``noise_var`` (a float or a 0-d float32 tensor, as ``channel.awgn``
    takes it) on ``clean``, guarded, decoded as one batch."""
    rx = channel.awgn(clean.expand(noise.shape[0], -1), noise_var, noise=noise)
    res = comm_link.rx_chain_batch(cfg, spec, tab, comm_link.guard(cfg, rx), estimator=estimator,
                                   soft=soft)
    errs = coding_bit_errors(res.decoded.payload, payload).sum(-1)
    return PointResult(bit_errors=errs, crc_ok=res.decoded.crc_ok)


def link_curve(
    cfg: OFDMConfig,
    spec: FrameSpec,
    tab: Tables,
    payload: torch.Tensor,
    snr_dbs,
    *,
    n_frames: int = 32,
    angle_deg: float = 0.0,
    path_loss: float = 10.0,
    cfo: float = 0.0,
    estimator: str = "ls",
    soft: bool = False,
    seed: int = 0,
    noise=None,
    points: list | None = None,
    jit: bool = True,
) -> list[LinkPoint]:
    """BER/PER at each SNR, each point's inputs from ``point_inputs``:
    ``noise[i]`` is point i's (n_frames, n) block; without it point i draws
    from a generator seeded with seed + 1000·i. ``points``, where given,
    collects each point's ``PointResult``.

    ``jit=True`` runs ``link_point`` on a card as one captured CUDA graph
    whose inputs are the noise block and the noise variance, a 0-d float32
    tensor (a float would be fixed in the graph at the first point's); the
    clean frame and the payload are read by address. ``jit=False`` makes
    every launch of a point from Python. Both give the same bits."""
    clean = clean_waveform(cfg, spec, tab, payload, angle_deg=angle_deg, path_loss=path_loss,
                           cfo=cfo)
    sig_pow = float(equalizer.abs2(clean).mean())

    def point(z: torch.Tensor, nv: torch.Tensor) -> PointResult:
        return link_point(cfg, spec, tab, payload, clean, nv, z, estimator=estimator, soft=soft)

    run = graph.jit(point, name="link_point") if jit else point
    out = []
    total_bits = 8 * spec.payload_bytes
    for i, snr in enumerate(np.atleast_1d(snr_dbs)):
        nv, z = point_inputs(clean, snr, n_frames, seed + 1000 * i, sig_pow=sig_pow,
                             noise=None if noise is None else noise[i])
        r = run(z, torch.full((), nv, dtype=torch.float32, device=clean.device))
        if points is not None:
            points.append(r)
        errs, ok = int(r.bit_errors.sum()), int(r.crc_ok.sum())
        out.append(LinkPoint(float(snr), errs / (n_frames * total_bits), 1.0 - ok / n_frames,
                             n_frames))
    return out
