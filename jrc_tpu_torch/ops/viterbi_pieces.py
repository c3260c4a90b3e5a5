"""P3: the pieces of the Viterbi forward pass (port of the Pallas profiling
kernel scripts/profile_viterbi_variants.py:35-126).

The add-compare-select pass over (T, B) channel values ``va``/``vb`` in one
of ``VARIANTS`` (see kernels/csrc/viterbi_pieces.cu), with the profiling
kernel's own semantics, which are not K1's: the metric starts at 1e9
except 0 for state 0 and is renormalized by pm[0] once per ``chunk_t``
steps; ``w0`` packs the decisions of states 0-31 and ``w1`` those of 32-63
at bit ``s % 32``. ``viterbi_pieces`` runs ``viterbi_pieces_plain`` for a
CPU tensor and the CUDA kernel for a CUDA tensor; each launch is
counted in ``kernels.registry``.
"""
from __future__ import annotations

import torch

from jrc_tpu_torch import kernels
from jrc_tpu_torch.kernels import registry
from jrc_tpu_torch.ops import viterbi

VARIANTS = ("full", "nopack", "norepeat", "noacs")


def _check(va: torch.Tensor, vb: torch.Tensor, variant: str, chunk_t: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if va.dim() != 2 or va.shape != vb.shape:
        raise ValueError(f"va, vb must be (T, B) of one shape, got {tuple(va.shape)}, {tuple(vb.shape)}")
    if chunk_t <= 0 or va.shape[0] % chunk_t:
        raise ValueError(f"T = {va.shape[0]} must be a multiple of chunk_t = {chunk_t}")


def viterbi_pieces_plain(va: torch.Tensor, vb: torch.Tensor, variant: str, chunk_t: int):
    """(T, B) float32 ``va``, ``vb`` → (w0, w1 (T, B) int32, pm (64, B) float32)."""
    _check(va, vb, variant, chunk_t)
    dev = va.device
    prev, sign_a, sign_b = (torch.as_tensor(a).to(dev) for a in viterbi._trellis())
    prev = prev.to(torch.int64)
    n_steps, b = va.shape
    pm = torch.full((64, b), 1e9, dtype=torch.float32, device=dev)
    pm[0] = 0.0
    w0 = torch.empty((n_steps, b), dtype=torch.int64, device=dev)
    w1 = torch.empty_like(w0)
    weights = (1 << (torch.arange(64, device=dev) % 32))[:, None]
    sa0, sa1 = sign_a[:, 0:1], sign_a[:, 1:2]
    sb0, sb1 = sign_b[:, 0:1], sign_b[:, 1:2]
    for t in range(n_steps):
        a, c = va[t][None].to(torch.float32), vb[t][None].to(torch.float32)
        if variant == "noacs":
            w0[t] = w1[t] = (a + c)[0].to(torch.int32)
        else:
            bm0 = -(sa0 * a + sb0 * c)
            bm1 = -(sa1 * a + sb1 * c)
            if variant == "norepeat":
                cand0, cand1 = pm + bm0, pm + bm1
            else:  # pm[s >> 1] and pm[(s >> 1) + 32]: the butterfly's repeat
                cand0, cand1 = pm[prev[:, 0]] + bm0, pm[prev[:, 1]] + bm1
            dec = cand1 < cand0
            pm = torch.minimum(cand0, cand1)
            if variant == "nopack":
                w0[t] = w1[t] = dec[0].to(torch.int64)
            else:
                bits = torch.where(dec, weights, 0)
                w0[t] = bits[:32].sum(0)
                w1[t] = bits[32:].sum(0)
        if (t + 1) % chunk_t == 0:
            pm = pm - pm[0:1]
    return viterbi._to_int32_word(w0), viterbi._to_int32_word(w1), pm


def viterbi_pieces(va: torch.Tensor, vb: torch.Tensor, variant: str, chunk_t: int):
    """(T, B) float32 ``va``, ``vb`` → (w0, w1 (T, B) int32, pm (64, B) float32)."""
    if va.device.type == "cpu":
        return viterbi_pieces_plain(va, vb, variant, chunk_t)
    _check(va, vb, variant, chunk_t)
    va = va.to(torch.float32).contiguous()
    vb = vb.to(torch.float32).contiguous()
    n_steps, b = va.shape
    w0 = torch.empty((n_steps, b), dtype=torch.int32, device=va.device)
    w1 = torch.empty_like(w0)
    pm = torch.empty((64, b), dtype=torch.float32, device=va.device)
    kernels.call("jrc_viterbi_pieces", kernels.ptr(va), kernels.ptr(vb), kernels.ptr(w0),
                 kernels.ptr(w1), kernels.ptr(pm), b, n_steps, chunk_t, VARIANTS.index(variant))
    registry.count("viterbi_pieces")
    return w0, w1, pm
