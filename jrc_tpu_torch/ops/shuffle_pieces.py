"""P1: row-permutation patterns of a (64, B) state (port of the Pallas
profiling kernel scripts/profile_shuffle.py:26-79).

``steps`` steps of ``pm ← f(pm)·0.5`` for one of ``VARIANTS`` (see
kernels/csrc/shuffle_pieces.cu). ``shuffle_pieces`` runs
``shuffle_pieces_plain`` for a CPU tensor and the CUDA kernel for a CUDA
tensor; each launch is counted in ``kernels.registry``. Both return the final
state and its sum (float64), the scalar the TPU script returned.
"""
from __future__ import annotations

import torch

from jrc_tpu_torch import kernels
from jrc_tpu_torch.kernels import registry

VARIANTS = ("baseline", "repeat2", "interleave", "concat", "halves", "roll8")


def _check(x: torch.Tensor, variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if x.dim() != 2 or x.shape[0] != 64:
        raise ValueError(f"state must be (64, B), got {tuple(x.shape)}")


def _step(pm: torch.Tensor, variant: str) -> torch.Tensor:
    if variant == "baseline":
        return pm + 1.0
    if variant == "repeat2":
        return pm[0:32].repeat_interleave(2, 0) + pm[32:64].repeat_interleave(2, 0)
    if variant == "interleave":
        b = pm.shape[1]
        y0 = torch.stack([pm[0:16], pm[16:32]], dim=1).reshape(32, b)
        y1 = torch.stack([pm[32:48], pm[48:64]], dim=1).reshape(32, b)
        return torch.cat([y0, y1])
    if variant == "concat":
        return torch.cat([pm[32:64], pm[0:32]])
    if variant == "halves":
        a, b = pm[0:32], pm[32:64]
        return torch.cat([torch.minimum(a + 1.0, b + 2.0), torch.minimum(a - 1.0, b - 2.0)])
    return torch.roll(pm, 8, dims=0)  # roll8


def shuffle_pieces_plain(x: torch.Tensor, variant: str, steps: int):
    """(64, B) float32 state → (state after ``steps`` steps, its sum)."""
    _check(x, variant)
    pm = x.to(torch.float32)
    for _ in range(steps):
        pm = _step(pm, variant) * 0.5
    return pm, pm.sum(dtype=torch.float64)


def shuffle_pieces(x: torch.Tensor, variant: str, steps: int):
    """(64, B) float32 state → (state after ``steps`` steps, its sum)."""
    if x.device.type == "cpu":
        return shuffle_pieces_plain(x, variant, steps)
    _check(x, variant)
    x = x.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    kernels.call("jrc_shuffle_pieces", kernels.ptr(x), kernels.ptr(out), x.shape[1], steps,
                 VARIANTS.index(variant))
    registry.count("shuffle_pieces")
    return out, out.sum(dtype=torch.float64)
