"""K1: Viterbi decode through the fused CUDA kernel of kernels/csrc/viterbi.cu.

``viterbi_decode`` chooses by the device of its input: a CPU tensor runs
the plain version (ops/viterbi.py), a CUDA tensor launches the kernel once
(forward pass and traceback in one launch), and a kernel that fails to
build or launch raises. Each launch is counted in ``kernels.registry``.

The kernel keeps a frame's decision words (8 bytes a step) in shared memory
while the whole batch fits on the card that way, else in a frame-major scratch
in device memory: ``decision_route`` makes that choice from the shape alone.

``n_steps`` gives each row its own extent: a caller whose rows are erasures
from ``n_steps[b]`` on (the SIG-driven receive path, whose frames share one
envelope) has each row's warp run only ``viterbi.row_extents`` steps, with
the bits of the full envelope, so the launch lasts as long as its longest
row. The extents stay on the device: the route is still chosen from (B, T).
With ``entry`` the launch also writes the longest row's steps and T into
that entry's ``viterbi_steps`` count (``utils.profiling``), with no extra
launch.
"""
from __future__ import annotations

import torch

from jrc_tpu_torch import kernels
from jrc_tpu_torch.kernels import registry
from jrc_tpu_torch.ops import viterbi
from jrc_tpu_torch.utils import profiling

FRAMES_PER_BLOCK = 4  # WARPS in viterbi.cu: one warp per frame
STAGE_BYTES = 512  # per frame: two 32-step windows of float2 values
MAX_BLOCK_SMEM = 232448  # 227 KB, the most dynamic shared memory of a block on sm_90
SM_SMEM = 233472  # 228 KB of shared memory on an SM; each resident block reserves 1 KB of it
N_SMS = 132  # streaming multiprocessors of an H100


def shared_block_bytes(t: int) -> int:
    """Dynamic shared memory of one block on the shared route (the words of
    t steps, rounded up to even so that pairs of steps stay 16-byte aligned)."""
    return FRAMES_PER_BLOCK * (8 * (t + t % 2) + STAGE_BYTES)


def decision_route(b: int, t: int) -> str:
    """Where the kernel keeps its decision words for a (b, 2t) batch:
    ``"shared"`` (shared memory only) while every frame of the batch is
    resident on the card at once, else ``"global"`` (scratch (b, t, 2): all
    frames resident, the words written to and read back from the L2). On an
    H100 a second wave of the shared route measured slower than the scratch
    route at (3072, 2160)."""
    block = shared_block_bytes(t)
    if block > MAX_BLOCK_SMEM:
        return "global"
    resident_blocks = N_SMS * (SM_SMEM // (block + 1024))
    return "shared" if -(-b // FRAMES_PER_BLOCK) <= resident_blocks else "global"


def viterbi_decode(values: torch.Tensor, trellis, n_out: int | None = None,
                   route: str | None = None, *, n_steps: torch.Tensor | None = None,
                   entry: str | None = None) -> torch.Tensor:
    """Decode (..., 2T) channel values → (..., T) uint8 bits (optionally
    truncated to ``n_out``). ``route`` overrides ``decision_route`` (for
    tests of both routes); the bits do not depend on it. ``n_steps`` (...,)
    integer: each row's values are erasures from that step on (see the
    module); ``entry`` names the entry point whose ``viterbi_steps`` count
    the launch writes."""
    if values.device.type == "cpu":
        bits = viterbi.viterbi_decode_plain(values, trellis, n_out, n_steps=n_steps)
        if entry is not None and values.numel():
            t = values.shape[-1] // 2
            steps = t if n_steps is None else int(viterbi.row_extents(n_steps.reshape(-1), t).max())
            profiling.count(entry, "viterbi_steps", steps, t, values)
        return bits
    if values.shape[-1] % 2:
        raise ValueError(f"an odd number of channel values: {values.shape[-1]}")
    batch_shape = values.shape[:-1]
    flat = values.reshape(-1, values.shape[-1]).to(torch.float32).contiguous()
    if flat.data_ptr() % 8:  # the kernel loads (va, vb) pairs as float2
        flat = flat.clone()
    B, T = flat.shape[0], flat.shape[1] // 2
    route = route or decision_route(B, T)
    if route not in ("shared", "global"):
        raise ValueError(f"route {route!r} is neither 'shared' nor 'global'")
    if route == "shared" and shared_block_bytes(T) > MAX_BLOCK_SMEM:
        raise ValueError(f"T={T} does not fit the shared route")
    if n_steps is not None:
        n_steps = n_steps.reshape(-1).to(device=flat.device, dtype=torch.int64).contiguous()
        if n_steps.shape[0] != B:
            raise ValueError(f"n_steps holds {n_steps.shape[0]} extents for {B} rows")
    bits = torch.empty((B, T), dtype=torch.uint8, device=flat.device)
    if B and T:
        scratch = (torch.empty((B, T, 2), dtype=torch.int32, device=flat.device)
                   if route == "global" else None)
        ring, counter = (None, None) if entry is None else profiling.count_ring(
            entry, "viterbi_steps", flat)
        kernels.call("jrc_viterbi_decode", kernels.ptr(flat),
                     kernels.ptr(scratch) if scratch is not None else None,
                     kernels.ptr(bits), B, T, int(route == "global"),
                     kernels.ptr(n_steps) if n_steps is not None else None,
                     kernels.ptr(ring) if ring is not None else None,
                     kernels.ptr(counter) if counter is not None else None, profiling.ROWS)
        registry.count("viterbi_decode")
    bits = bits.reshape(*batch_shape, T)
    return bits if n_out is None else bits[..., :n_out]
