"""Data-parallel batches over the ranks of a mesh (port of
jrc_tpu/parallel/batch.py): many dwells or captures, each rank its shard
of the batch's leading axis, the results all-gathered in rank order.

Compiled as the reference's ``jax.jit``s: each rank's shard is taken and
moved to its compute device op by op, then the computation and the gather
run as one captured CUDA graph on an NCCL mesh, op by op on gloo
(``streaming.mesh_step``, the rule of ``streaming.captures``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from jrc_tpu_torch.config import OFDMConfig
from jrc_tpu_torch.models import streaming
from jrc_tpu_torch.ops import radar
from jrc_tpu_torch.parallel.mesh import comm_device, compute_device, shard_batch
from jrc_tpu_torch.parallel.streaming import cached_tables, mesh_step


def _gather_batch(mesh: DeviceMesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's (rows, ...) along ``"batch"`` → (ranks·rows, ...)."""
    group = mesh.get_group("batch")
    comm = comm_device(mesh)
    parts = [torch.empty_like(local, device=comm) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local.to(comm).contiguous(), group=group)
    return torch.cat(parts).to(local.device)


def batched_range_angle_maps(mesh: DeviceMesh, chans, interp_factor_range: int = 8,
                             interp_factor_angle: int = 16, *, device=None) -> torch.Tensor:
    """|range-angle map|² of each of (n_dwells, n_virt, fft_len) channel
    estimates, this rank's shard computed on its compute device →
    (n_dwells, fft_len·ir, n_virt·ia) float32 on every rank."""
    h = torch.as_tensor(shard_batch(mesh, chans)).to(device=compute_device(device),
                                                      dtype=torch.complex64)
    return mesh_step(_maps, mesh, interp_factor_range, interp_factor_angle, x=h)


def _maps(mesh, interp_factor_range, interp_factor_angle, h):
    maps = radar.range_angle_map(h, interp_factor_range, interp_factor_angle)
    return _gather_batch(mesh, maps.real * maps.real + maps.imag * maps.imag)


def batched_rx(mesh: DeviceMesh, cfg: OFDMConfig, spec, captures, *, max_frames: int = 8,
               device=None) -> torch.Tensor:
    """Decode a batch of independent captures (n_captures, n_samples), each
    with its trailing halo, data-parallel over ``"batch"``: this rank's
    shard through ``rx_block`` as one batch of windows → per-capture
    (n_frames, n_crc_ok) float32 counts (n_captures, 2) on every rank."""
    dev = compute_device(device)
    caps = torch.as_tensor(shard_batch(mesh, captures)).to(device=dev, dtype=torch.complex64)
    return mesh_step(_counts, mesh, cfg, spec, max_frames, x=caps)


def _counts(mesh, cfg, spec, max_frames, caps):
    block_len = caps.shape[-1] - (streaming.frame_window_samples(cfg, spec) + cfg.fft_len)
    res = streaming.rx_block(cfg, spec, cached_tables(cfg, spec, 0, caps.device), caps,
                             block_len, max_frames=max_frames)
    counts = torch.stack([res.valid.sum(-1), res.crc_ok.sum(-1)], dim=-1).to(torch.float32)
    return _gather_batch(mesh, counts)
