"""Time-block sharded streaming RX over the ranks of a device mesh (port of
jrc_tpu/parallel/streaming.py on torch.distributed).

SPMD: every rank of the mesh's ``"time"`` axis calls ``sharded_rx`` (or
``sharded_rx_dynamic``) with its own block of the capture, the counterpart
of the reference's ``P('time')`` shard (``local_block`` takes it out of a
whole capture). The reference's two ``ppermute``s become one
``batch_isend_irecv`` between neighbours: each rank sends the head of its
block (``halo`` samples) to its left neighbour and its tail (``left_hist``
samples) to its right neighbour, as ``view_as_real`` float32 on the mesh's
device, so that a frame straddling a boundary is decoded once, by the rank
that owns its trigger. Rank 0's left history and the last rank's right
halo are zero; a world of one exchanges nothing. The block decodes through
``flat_rx`` / ``flat_rx_dynamic`` when its length is a multiple of
``sync.SEG``, else through ``rx_block`` / ``rx_block_dynamic``. The link
totals are one all-reduce (the reference's ``psum``) and the per-block
fields all-gathered, so every rank returns the reference's
``(n_ranks, max_frames, ...)`` arrays, with ``start`` global.

Compiled, as the reference's ``jax.jit(shard_map(...))``: on a mesh whose
collectives run on the compute device (NCCL, ``captures``) the whole step,
halos, decode, all-reduce and all-gathers, is one captured CUDA graph
(``utils.graph``), built once per geometry (config, spec, mesh, slots,
detection settings, estimator, soft, max_payload, and the block's shape)
and replayed. A gloo mesh moves every halo and field through the host,
which a graph cannot hold, so there the step runs op by op: the rule is
the mesh's device type, decided before any capture.

A recording longer than one step is decoded in steps of one shape
(``file_steps``): every step a replay of the one captured graph, the steps
overlapping by the halo and the history, so that each trigger of the file
lies in one step's kept span with its whole frame and its detector's
look-back inside that step. ``slots_for`` gives a rank's block its frame
slots.

The step stamps the stage clock of ``utils.profiling`` (entry ``"mesh"``):
``start`` before the halo exchange, ``halo`` after it, ``decode`` after the
decode and the global starts, ``collect`` after the all-reduce and the
all-gathers; the decode's ``"rx"`` stamps fire inside. On NCCL the stamps
are launches on the compute stream, so the captured step holds them.
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from jrc_tpu_torch import tables
from jrc_tpu_torch.config import OFDMConfig
from jrc_tpu_torch.models import streaming as block_rx
from jrc_tpu_torch.ops import sync
from jrc_tpu_torch.ops.encoder import FrameSpec
from jrc_tpu_torch.parallel.mesh import captured_steps, comm_device, compute_device
from jrc_tpu_torch.utils import graph
from jrc_tpu_torch.utils.profiling import stamp


class ShardedRxResult(NamedTuple):
    payload: torch.Tensor  # (n_ranks, max_frames, payload_bytes)
    crc_ok: torch.Tensor
    valid: torch.Tensor
    snr_db: torch.Tensor
    start: torch.Tensor  # global sample index of each frame trigger (-1 for a free slot)
    n_frames: torch.Tensor  # 0-d: frames over the mesh (all-reduced)
    n_crc_ok: torch.Tensor  # 0-d


class ShardedDynRxResult(NamedTuple):
    payload: torch.Tensor  # (n_ranks, max_frames, max_payload)
    payload_len: torch.Tensor
    crc_ok: torch.Tensor
    sig_ok: torch.Tensor
    mcs: torch.Tensor
    packet_type_bit: torch.Tensor
    valid: torch.Tensor
    snr_db: torch.Tensor
    snr_data_db: torch.Tensor
    start: torch.Tensor
    chan_est: torch.Tensor  # (n_ranks, max_frames, fft_len, n_tx) NDP estimate
    chan_est_ok: torch.Tensor
    n_frames: torch.Tensor
    n_crc_ok: torch.Tensor


@lru_cache(maxsize=64)
def cached_tables(cfg: OFDMConfig, spec: FrameSpec | None, max_payload: int,
                  device: torch.device):
    """The constant tables of one geometry on one device, built once
    (``spec=None``: the dynamic path's)."""
    if spec is None:
        return tables.from_numpy_dynamic(cfg, max_payload, device)
    return tables.from_numpy(cfg, spec, device)


def local_block(mesh: DeviceMesh, samples, *, device=None) -> torch.Tensor:
    """This rank's block of a whole capture (its length must divide by the
    ranks of ``"time"``), complex64 on the compute device."""
    n = mesh.size(mesh.mesh_dim_names.index("time"))
    if samples.shape[-1] % n:
        raise ValueError(f"{samples.shape[-1]} samples do not divide over {n} ranks")
    block_len = samples.shape[-1] // n
    r = mesh.get_local_rank("time")
    block = torch.as_tensor(samples[r * block_len : (r + 1) * block_len])
    return block.to(device=compute_device(device), dtype=torch.complex64)


def edges(cfg: OFDMConfig, spec: FrameSpec | None, max_payload: int) -> tuple[int, int]:
    """(halo, history) of a rank's block: the samples it takes from the head
    of its right neighbour's block (the longest frame from a trigger, plus
    one FFT) and from the tail of its left neighbour's (the detector's
    look-back); ``spec=None``: the dynamic path's, at ``max_payload``."""
    if spec is None:
        halo = block_rx.frame_window_samples_dynamic(cfg, max_payload)
    else:
        halo = block_rx.frame_window_samples(cfg, spec)
    return halo + cfg.fft_len, block_rx.left_history_samples(cfg)


def slots_for(block: int, block_len: int) -> int:
    """Frame slots of a rank's block of ``block`` samples: the streamer's 32 a
    ``block_len`` that it spans, so that every number of ranks decodes the
    same frames of a recording."""
    return 32 * -(-block // block_len)


class FileStep(NamedTuple):
    lo: int  # the step's first sample in the recording
    keep_lo: int  # its frames: the triggers at global samples [keep_lo, keep_hi)
    keep_hi: int


def file_steps(n: int, step: int, halo: int, history: int) -> list[FileStep]:
    """The steps of ``step`` samples that decode a recording of ``n``. One
    step where ``n <= step``. Else step k starts at k · (step − halo −
    history) and keeps the triggers from ``history`` past its start (the
    first from 0) up to where the next one's begin: a kept frame and its
    detector's look-back then lie inside the step, and every trigger lies in
    one kept span. The last step keeps the rest and runs past the recording
    (its caller pads it with zeros)."""
    if n <= step:
        return [FileStep(0, 0, n)]
    stride = step - halo - history
    if stride <= 0:
        raise ValueError(f"a step of {step} samples does not exceed halo {halo} + history "
                         f"{history}")
    out, lo = [], 0
    while lo + step < n:
        out.append(FileStep(lo, lo + history if lo else 0, lo + stride + history))
        lo += stride
    out.append(FileStep(lo, lo + history, n))
    return out


def _exchange_halos(mesh: DeviceMesh, block: torch.Tensor, halo: int, left_hist: int):
    """(left history, right halo) of this rank's block, from its neighbours
    along ``"time"``; zeros at the ends of the mesh."""
    group = mesh.get_group("time")
    n, r = dist.get_world_size(group), dist.get_rank(group)
    comm = comm_device(mesh)
    left = torch.zeros(left_hist, 2, dtype=torch.float32, device=comm)
    right = torch.zeros(halo, 2, dtype=torch.float32, device=comm)
    real = torch.view_as_real(block)
    ops = []
    if r > 0:  # head → left neighbour, its tail ← left neighbour
        peer = dist.get_global_rank(group, r - 1)
        ops += [dist.P2POp(dist.isend, real[:halo].to(comm).contiguous(), peer, group),
                dist.P2POp(dist.irecv, left, peer, group)]
    if r < n - 1:  # tail → right neighbour, its head ← right neighbour
        peer = dist.get_global_rank(group, r + 1)
        ops += [dist.P2POp(dist.isend, real[-left_hist:].to(comm).contiguous(), peer, group),
                dist.P2POp(dist.irecv, right, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return (torch.view_as_complex(left).to(block.device),
            torch.view_as_complex(right).to(block.device))


def _all_gather(mesh: DeviceMesh, fields: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each field of every rank along ``"time"``, stacked on a new leading
    axis in rank order (complex fields as float32 pairs on the wire)."""
    group = mesh.get_group("time")
    n = dist.get_world_size(group)
    out = []
    for field in fields:
        wire = (torch.view_as_real(field) if field.is_complex() else field).contiguous()
        wire = wire.to(comm_device(mesh))
        parts = [torch.empty_like(wire) for _ in range(n)]
        dist.all_gather(parts, wire, group=group)
        got = torch.stack(parts).to(field.device)
        out.append(torch.view_as_complex(got) if field.is_complex() else got)
    return out


def captures(mesh: DeviceMesh, x: torch.Tensor) -> bool:
    """Whether a step on ``mesh`` over ``x`` runs as a captured CUDA graph: its
    collectives run on the compute device (NCCL) and ``x`` lies there."""
    return mesh.device_type == "cuda" and x.device.type == "cuda"


def mesh_step(body, mesh: DeviceMesh, *static, x: torch.Tensor):
    """``body(mesh, *static, x)``: captured on an NCCL mesh, op by op on gloo.
    The captured functions live on the mesh object (``mesh.captured_steps``),
    one per ``(body, *static)`` (the block's shape selects the graph inside):
    two meshes of two process groups compare equal, and a graph holds its
    own group's collectives. ``mesh.teardown`` frees them before it destroys
    the group."""
    if not captures(mesh, x):
        return body(mesh, *static, x)
    cache = captured_steps(mesh)
    key = (body, *static)
    if key not in cache:
        cache[key] = graph.jit(partial(body, mesh, *static), name=body.__qualname__)
    return cache[key](x)


def _sharded(mesh, cfg, spec, max_frames_per_block, max_payload, threshold, min_n_peaks,
             estimator, soft, block):
    """The per-rank body: halos, decode, global starts, totals, gather."""
    block_len = block.shape[-1]
    dynamic = spec is None
    halo, left_hist = edges(cfg, spec, max_payload)
    if not (halo <= block_len and left_hist <= block_len):
        raise ValueError(f"block_len {block_len} must exceed halo {halo} and history "
                         f"{left_hist}; use fewer ranks or longer captures")
    block = block.to(torch.complex64)
    stamp("mesh", "start", block)
    left, right = _exchange_halos(mesh, block, halo, left_hist)
    stamp("mesh", "halo", block)
    x_ext = torch.cat([left, block, right])
    tab = cached_tables(cfg, spec, max_payload, block.device)
    kw = dict(max_frames=max_frames_per_block, threshold=threshold, min_n_peaks=min_n_peaks,
              estimator=estimator, soft=soft)
    flat_ok = block_len % sync.SEG == 0
    if dynamic:
        kw["max_payload"] = max_payload
        if flat_ok:
            res = block_rx.flat_rx_dynamic(cfg, tab, x_ext, block_len, 1, left_hist, **kw)
        else:
            res = block_rx.rx_block_dynamic(cfg, tab, x_ext, block_len, own_lo=left_hist, **kw)
    elif flat_ok:
        res = block_rx.flat_rx(cfg, spec, tab, x_ext, block_len, 1, left_hist, **kw)
    else:
        res = block_rx.rx_block(cfg, spec, tab, x_ext, block_len, own_lo=left_hist, **kw)
    group = mesh.get_group("time")
    res = res._replace(start=torch.where(res.valid, res.start + dist.get_rank(group) * block_len,
                                         -1))
    stamp("mesh", "decode", block)
    totals = torch.stack([res.valid.sum(), res.crc_ok.sum()]).to(comm_device(mesh))
    dist.all_reduce(totals, group=group)
    totals = totals.to(block.device)
    gathered = type(res)(*_all_gather(mesh, list(res)))
    stamp("mesh", "collect", block)
    return gathered, totals[0], totals[1]


def sharded_rx(
    cfg: OFDMConfig,
    spec: FrameSpec,
    mesh: DeviceMesh,
    block: torch.Tensor,  # this rank's (block_len,) samples on its compute device
    *,
    max_frames_per_block: int = 8,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
) -> ShardedRxResult:
    """The sharded streaming RX step of the known spec; every rank of
    ``"time"`` calls it with its block and gets every rank's slots and the
    totals."""
    g, n_frames, n_ok = mesh_step(_sharded, mesh, cfg, spec, max_frames_per_block, 0,
                                  threshold, min_n_peaks, estimator, soft, x=block)
    return ShardedRxResult(payload=g.payload, crc_ok=g.crc_ok, valid=g.valid, snr_db=g.snr_db,
                           start=g.start, n_frames=n_frames, n_crc_ok=n_ok)


def sharded_rx_dynamic(
    cfg: OFDMConfig,
    mesh: DeviceMesh,
    block: torch.Tensor,
    *,
    max_frames_per_block: int = 8,
    max_payload: int = 256,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
) -> ShardedDynRxResult:
    """SIG-driven variant: every rank decodes whatever MCS/length/type its
    owned frames announce."""
    g, n_frames, n_ok = mesh_step(_sharded, mesh, cfg, None, max_frames_per_block, max_payload,
                                  threshold, min_n_peaks, estimator, soft, x=block)
    return ShardedDynRxResult(**{k: getattr(g, k) for k in ShardedDynRxResult._fields[:-2]},
                              n_frames=n_frames, n_crc_ok=n_ok)
