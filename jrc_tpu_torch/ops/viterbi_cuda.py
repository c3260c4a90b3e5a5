"""K1: Viterbi decode through the CUDA kernels of kernels/csrc/viterbi.cu.

Each wrapper chooses by the device of its input: a CPU tensor runs the
plain version (ops/viterbi.py), a CUDA tensor launches the kernel, and a
kernel that fails to build or launch raises. ``launches`` counts kernel
launches only.
"""
from __future__ import annotations

import torch

from jrc_tpu_torch import kernels
from jrc_tpu_torch.ops import viterbi


def viterbi_acs(values: torch.Tensor, trellis) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 2T) float32 values → (words (T, 2, B) int32, end_state (B,) int32)."""
    if values.device.type == "cpu":
        return viterbi.viterbi_acs_plain(values, trellis)
    values = values.to(torch.float32).contiguous()
    B, T = values.shape[0], values.shape[1] // 2
    words = torch.empty((T, 2, B), dtype=torch.int32, device=values.device)
    end_state = torch.empty(B, dtype=torch.int32, device=values.device)
    kernels.call("jrc_viterbi_acs", kernels.ptr(values), kernels.ptr(words),
                 kernels.ptr(end_state), B, T)
    viterbi_acs.launches += 1
    return words, end_state


viterbi_acs.launches = 0


def viterbi_traceback(words: torch.Tensor, end_state: torch.Tensor) -> torch.Tensor:
    """(T, 2, B) decision words + (B,) end state → (B, T) uint8 bits."""
    if words.device.type == "cpu":
        return viterbi.viterbi_traceback_plain(words, end_state)
    T, _, B = words.shape
    words = words.to(torch.int32).contiguous()
    end_state = end_state.to(torch.int32).contiguous()
    bits = torch.empty((B, T), dtype=torch.uint8, device=words.device)
    kernels.call("jrc_viterbi_traceback", kernels.ptr(words), kernels.ptr(end_state),
                 kernels.ptr(bits), B, T)
    viterbi_traceback.launches += 1
    return bits


viterbi_traceback.launches = 0


def viterbi_decode(values: torch.Tensor, trellis, n_out: int | None = None) -> torch.Tensor:
    """Decode (..., 2T) channel values → (..., T) uint8 bits."""
    batch_shape = values.shape[:-1]
    words, end_state = viterbi_acs(values.reshape(-1, values.shape[-1]), trellis)
    bits = viterbi_traceback(words, end_state)
    bits = bits.reshape(*batch_shape, bits.shape[-1])
    return bits if n_out is None else bits[..., :n_out]
