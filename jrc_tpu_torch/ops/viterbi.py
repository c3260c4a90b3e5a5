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

A row may end in erasures: with ``n_steps`` (B,) the caller promises 0.0 at
every step ≥ ``n_steps[b]``, and row b runs only ``row_extents`` = min(
``n_steps[b]`` + ``TAIL``, T) steps, takes its end state there, traces back
from it and reads 0 after it. These are the full envelope's bits: past
``n_steps[b]`` every branch cost is ±0, so after ``TAIL`` steps (the code's
memory) every path metric is the minimum over all states, exactly 0, every
later decision is the strict compare's j = 0, the first-index argmin is
state 0 and the traceback from state 0 emits 0s (kernels/csrc/viterbi.cu).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from jrc_tpu_torch.config import CONV_POLY_A, CONV_POLY_B

N_STATES = 64
#: erasure steps after which every path metric is exactly 0: the code's memory, K − 1
TAIL = 6


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


def row_extents(n_steps: torch.Tensor, t: int) -> torch.Tensor:
    """The steps each row runs when its values are erasures from ``n_steps``
    on: min(n_steps + ``TAIL``, t), with a negative extent read as 0."""
    return (n_steps.to(torch.int64).clamp_min(0) + TAIL).clamp_max(t)


def viterbi_acs_plain(values: torch.Tensor, trellis,
                      stop: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 2T) values → (words (T', 2, B) int32, end_state (B,) int32). With
    ``stop`` (B,) (each row's ``row_extents``) the pass runs T' = the longest
    row's steps, read on the host, and each row's end state is taken after
    its own ``stop[b]`` steps; else T' = T."""
    prev, sign_a, sign_b = trellis
    n_steps = values.shape[-1] // 2
    v = values.reshape(-1, n_steps, 2).to(torch.float32)
    B = v.shape[0]
    if stop is not None:
        n_steps = int(stop.max()) if B else 0
    pm = torch.full((B, N_STATES), 1e9, dtype=torch.float32, device=v.device)
    pm[:, 0] = 0.0
    weights = 1 << torch.arange(32, dtype=torch.int64, device=v.device)
    words = torch.empty((n_steps, 2, B), dtype=torch.int64, device=v.device)
    end_state = torch.zeros(B, dtype=torch.int64, device=v.device)
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
        if stop is not None:
            end_state = torch.where(stop == t + 1, torch.argmin(pm, dim=-1), end_state)
    if stop is None:
        end_state = torch.argmin(pm, dim=-1)
    return _to_int32_word(words), end_state.to(torch.int32)


def viterbi_traceback_plain(words: torch.Tensor, end_state: torch.Tensor,
                            stop: torch.Tensor | None = None) -> torch.Tensor:
    """(T', 2, B) decision words + (B,) end state → (B, T') uint8 bits. With
    ``stop`` (B,) row b walks back from its end state at step ``stop[b]`` and
    reads 0 after it."""
    state = end_state.to(torch.int32)
    out = []
    for t in range(words.shape[0] - 1, -1, -1):
        word = torch.where((state & 1) == 1, words[t, 1], words[t, 0])
        j = (word >> (state >> 1)) & 1
        bit = (state & 1).to(torch.uint8)
        nxt = (state >> 1) + 32 * j
        if stop is not None:
            live = t < stop
            bit = torch.where(live, bit, 0)
            nxt = torch.where(live, nxt, state)
        out.append(bit)
        state = nxt
    if not out:
        return torch.zeros((end_state.shape[0], 0), dtype=torch.uint8, device=words.device)
    return torch.stack(out[::-1], dim=1)


def viterbi_decode_plain(values: torch.Tensor, trellis, n_out: int | None = None, *,
                         n_steps: torch.Tensor | None = None,
                         entry: str | None = None) -> torch.Tensor:
    """Decode (..., 2T) channel values → (..., T) uint8 bits (optionally
    truncated to ``n_out``). ``n_steps`` (...,): each row's values are
    erasures from that step on, and the row runs to its own extent (see the
    module). ``entry`` is the wrapper's (``viterbi_cuda.viterbi_decode``),
    taken so that this version can stand in for it
    (``kernels.registry.plain_kernels``); it writes no count."""
    batch_shape = values.shape[:-1]
    flat = values.reshape(-1, values.shape[-1])
    t = flat.shape[-1] // 2
    stop = None if n_steps is None else row_extents(n_steps.reshape(-1), t)
    words, end_state = viterbi_acs_plain(flat, trellis, stop)
    bits = viterbi_traceback_plain(words, end_state, stop)
    if bits.shape[-1] < t:
        bits = torch.nn.functional.pad(bits, (0, t - bits.shape[-1]))
    bits = bits.reshape(*batch_shape, t)
    return bits if n_out is None else bits[..., :n_out]


def viterbi_decode_chunked(values: torch.Tensor, n_out: int | None = None,
                           chunk_len: int = 128) -> torch.Tensor:
    """Chunk-parallel Viterbi (port of jrc_tpu/ops/viterbi.py:134-247): the
    reference's chunked decoder bit for bit, ties included, in about
    4·L + 2·T/L sequential steps instead of 2·T. It equals
    ``viterbi_decode_plain`` up to ties: where two paths tie, the chunked
    metrics (summed in another order) can pick the other one.

    The trellis is cut into C chunks of L = ``chunk_len`` steps. Phase A
    builds each chunk's min-plus transfer matrix (B, C, 64 entry, 64 exit),
    renormalized by its min every step; phase B scans them into each
    chunk's entry metrics; phase C re-runs the ACS inside every chunk at
    once from those metrics, recording the strict ``cand1 < cand0``
    decisions; phases D/E compose the backpointer maps within each chunk
    (exit → entry state); a C-step scan from the first-index argmin end
    state pins the survivor's chunk boundary states; phase F traces back
    inside every chunk at once. Plain torch on the device of ``values``
    (the reference computes it outside any Pallas kernel). Each step of
    phase A makes (B, C, 64, 64, 2) float32 candidates: 0.5 GB at B = 3072,
    T = 576, L = 128.
    """
    dev = values.device
    prev_np, sa_np, sb_np = _trellis()
    prev = torch.from_numpy(prev_np).to(device=dev, dtype=torch.int64)  # (64, 2)
    sign_a = torch.from_numpy(sa_np).to(dev)
    sign_b = torch.from_numpy(sb_np).to(dev)

    batch_shape = values.shape[:-1]
    t_steps = values.shape[-1] // 2
    L = chunk_len
    C = -(-t_steps // L)
    v = values.reshape(-1, t_steps, 2).to(torch.float32)
    B = v.shape[0]
    if C * L > t_steps:
        v = torch.nn.functional.pad(v, (0, 0, 0, C * L - t_steps))  # zero = erasure

    # branch metrics, step-major: (L, B, C, 64, 2)
    va = v[..., 0][..., None, None]
    vb = v[..., 1][..., None, None]
    bm = -(sign_a * va + sign_b * vb)  # (B, C·L, 64, 2)
    bm_l = bm.reshape(B, C, L, N_STATES, 2).movedim(2, 0)
    inf = 1e9

    # phase A: per-chunk transfer matrices m[b, c, entry i, state s]
    eye = torch.eye(N_STATES, dtype=torch.bool, device=dev)
    m = torch.where(eye, 0.0, inf).to(torch.float32).expand(B, C, N_STATES, N_STATES)
    for t in range(L):
        new = (m[..., prev] + bm_l[t][:, :, None]).amin(dim=-1)  # (B, C, 64, 64)
        m = new - new.amin(dim=(-2, -1), keepdim=True)

    # phase B: chunk entry metrics
    pm = torch.full((B, N_STATES), inf, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    entries = []
    for c in range(C):
        entries.append(pm)
        nxt = (pm[:, :, None] + m[:, c]).amin(dim=1)
        pm = nxt - nxt.amin(dim=-1, keepdim=True)
    pm_final, entries = pm, torch.stack(entries, dim=1)  # (B, C, 64)

    # phase C: in-chunk ACS from the entry metrics, recording decisions
    decs = []
    pm = entries
    for t in range(L):
        cand = pm[..., prev] + bm_l[t]  # (B, C, 64, 2)
        dec = cand[..., 1] < cand[..., 0]
        new = torch.where(dec, cand[..., 1], cand[..., 0])
        pm = new - new.amin(dim=-1, keepdim=True)
        decs.append(dec)
    decs = torch.stack(decs).to(torch.uint8)  # (L, B, C, 64)

    # phases D/E: compose the backpointer maps within chunks (exit → entry)
    half = (torch.arange(N_STATES, device=dev) >> 1).expand(B, C, N_STATES)
    maps = torch.arange(N_STATES, device=dev).expand(B, C, N_STATES)
    for t in range(L - 1, -1, -1):
        maps = torch.gather(half + 32 * decs[t].to(torch.int64), -1, maps)

    # chunk boundary states, from the best end state back (C steps)
    exits = [None] * C
    state = torch.argmin(pm_final, dim=-1)  # (B,), first minimum as jnp.argmin
    for c in range(C - 1, -1, -1):
        exits[c] = state
        state = torch.gather(maps[:, c], -1, state[:, None])[:, 0]
    state = torch.stack(exits, dim=1)  # (B, C)

    # phase F: parallel within-chunk traceback
    bits = [None] * L
    for t in range(L - 1, -1, -1):
        d = torch.gather(decs[t], -1, state[..., None])[..., 0].to(torch.int64)
        bits[t] = (state & 1).to(torch.uint8)
        state = (state >> 1) + 32 * d
    bits = torch.stack(bits, dim=-1).reshape(B, C * L)[:, :t_steps]
    bits = bits.reshape(*batch_shape, t_steps)
    return bits if n_out is None else bits[..., :n_out]
