"""Viterbi decoder for the K=7, rate-1/2 code: the plain PyTorch version of
kernel K1 (port of jrc_tpu/ops/viterbi.py:46-131).

Channel values follow ``v > 0 ⇒ bit 1`` with 0 = erasure.
``viterbi_decode_plain`` is what the fused CUDA kernel of ``viterbi_cuda``
is held against, bit for bit. It is composed of the decoder's two passes:

* ``viterbi_acs_plain`` — add-compare-select over T steps with the per-step
  min renormalization and the strict ``cand1 < cand0`` tie rule. Each
  step's 64 decisions are packed into two int32 words: word 0 bit u =
  decision of state 2u, word 1 bit u = decision of state 2u+1. Also returns
  the first-index argmin end state.
* ``viterbi_traceback_plain`` — walks the words back from the end state.

The words stay inside this module: the kernel keeps its own decision words
on the chip and shares only the (B, 2T) → (B, T) interface.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from jrc_tpu_torch.config import CONV_POLY_A, CONV_POLY_B

N_STATES = 64


def _parity(x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    for k in range(7):
        out ^= (x >> k) & 1
    return out


@lru_cache(maxsize=1)
def _trellis():
    """prev[s', j]: predecessor j∈{0,1} of next-state s'; sign_a/b[s', j]:
    ±1 expected-output signs for polys 0o155/0o117."""
    s_next = np.arange(N_STATES)
    j = np.arange(2)
    prev = (s_next[:, None] >> 1) + 32 * j[None, :]
    full7 = (prev << 1) | (s_next[:, None] & 1)
    e_a = _parity(full7 & CONV_POLY_A)
    e_b = _parity(full7 & CONV_POLY_B)
    return (
        prev.astype(np.int32),
        (2 * e_a - 1).astype(np.float32),
        (2 * e_b - 1).astype(np.float32),
    )


def hard_to_values(bits: torch.Tensor) -> torch.Tensor:
    """Hard bits {0,1} → channel values {−1,+1} (float32)."""
    return 2.0 * bits.to(torch.float32) - 1.0


def _to_int32_word(w: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern → the int32 with the same bits."""
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def viterbi_acs_plain(values: torch.Tensor, trellis) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 2T) values → (words (T, 2, B) int32, end_state (B,) int32)."""
    prev, sign_a, sign_b = trellis
    n_steps = values.shape[-1] // 2
    v = values.reshape(-1, n_steps, 2).to(torch.float32)
    B = v.shape[0]
    pm = torch.full((B, N_STATES), 1e9, dtype=torch.float32, device=v.device)
    pm[:, 0] = 0.0
    weights = 1 << torch.arange(32, dtype=torch.int64, device=v.device)
    words = torch.empty((n_steps, 2, B), dtype=torch.int64, device=v.device)
    for t in range(n_steps):
        va = v[:, t, 0][:, None, None]
        vb = v[:, t, 1][:, None, None]
        # branch cost: −(2e−1)·v  (negative when the value agrees with e)
        bm = -(sign_a * va + sign_b * vb)  # (B, 64, 2)
        cand = pm[:, prev] + bm
        dec = cand[..., 1] < cand[..., 0]  # True ⇒ take j=1
        new_pm = torch.where(dec, cand[..., 1], cand[..., 0])
        pm = new_pm - new_pm.min(dim=-1, keepdim=True).values
        words[t, 0] = (dec[:, 0::2].to(torch.int64) * weights).sum(-1)
        words[t, 1] = (dec[:, 1::2].to(torch.int64) * weights).sum(-1)
    end_state = torch.argmin(pm, dim=-1).to(torch.int32)
    return _to_int32_word(words), end_state


def viterbi_traceback_plain(words: torch.Tensor, end_state: torch.Tensor) -> torch.Tensor:
    """(T, 2, B) decision words + (B,) end state → (B, T) uint8 bits."""
    state = end_state.to(torch.int32)
    out = []
    for t in range(words.shape[0] - 1, -1, -1):
        word = torch.where((state & 1) == 1, words[t, 1], words[t, 0])
        j = (word >> (state >> 1)) & 1
        out.append((state & 1).to(torch.uint8))
        state = (state >> 1) + 32 * j
    return torch.stack(out[::-1], dim=1)


def viterbi_decode_plain(values: torch.Tensor, trellis, n_out: int | None = None) -> torch.Tensor:
    """Decode (..., 2T) channel values → (..., T) uint8 bits (optionally
    truncated to ``n_out``)."""
    batch_shape = values.shape[:-1]
    words, end_state = viterbi_acs_plain(values.reshape(-1, values.shape[-1]), trellis)
    bits = viterbi_traceback_plain(words, end_state)
    bits = bits.reshape(*batch_shape, bits.shape[-1])
    return bits if n_out is None else bits[..., :n_out]
