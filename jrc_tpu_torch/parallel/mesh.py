"""Process groups and device meshes of the sharded executors (port of
jrc_tpu/parallel/mesh.py on torch.distributed).

One process a rank. A mesh spans every rank of the current process group
and carries the reference's axis names; its device type is that of its
collectives: ``"cuda"`` under NCCL, ``"cpu"`` under gloo (whose
point-to-point calls take CPU tensors). The device a rank computes on is
separate (``compute_device``): by default the rank's CUDA device, so two
gloo ranks can decode on one card while their halos and counts cross on
the CPU. The backend is always the caller's choice.

Every program that joins a group leaves it through ``teardown``. A step
captured on an NCCL mesh (``streaming.mesh_step``) holds the group's
communicator in its CUDA graph, and NCCL does not complete the destroy of a
communicator while a graph that holds its kernels lives (NCCL 2.28 under
torch 2.11): ``dist.destroy_process_group`` then waits forever on every
rank. ``teardown`` frees the captured steps first: every one lives in the
dict ``captured_steps`` gives its mesh, which registers the mesh with
``teardown`` however it was built.
"""
from __future__ import annotations

import contextlib
import gc
import os
import tempfile
import weakref

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: the meshes of this process that hold captured steps, by identity (two
#: meshes of two groups compare equal); ``teardown`` frees their steps.
#: Process-wide, as torch.distributed's own group state is
_MESHES: weakref.WeakValueDictionary[int, DeviceMesh] = weakref.WeakValueDictionary()


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, *, backend: str) -> None:
    """Join the process group named by the arguments or, where they are
    None, by torchrun's environment (MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK). ``coordinator`` is ``host:port`` or an init-method
    URL (``tcp://``, ``file://``). Nothing happens in a single process (no
    coordinator given or in the environment) or once the group exists."""
    if dist.is_initialized():
        return
    if coordinator is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if addr is None or port is None:
            return
        coordinator = f"{addr}:{port}"
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:  # an explicit rank 0 must not fall through to the environment
        process_id = int(os.environ["RANK"])
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)


def captured_steps(mesh: DeviceMesh) -> dict:
    """The captured steps that ``mesh`` holds (an empty dict at first), for
    ``streaming.mesh_step`` to fill; ``mesh`` is registered with
    ``teardown``, which frees them, whether this module built it or not."""
    _MESHES[id(mesh)] = mesh
    return mesh.__dict__.setdefault("_captured_steps", {})


def teardown() -> None:
    """Leave the process group: synchronize this rank's card, free every
    step captured on a mesh of the group while its communicators live, wait
    for every rank at a barrier, then destroy the group. Nothing happens
    without a group, so a second call is harmless."""
    if not dist.is_initialized():
        return
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()  # no replay still in flight
    for m in list(_MESHES.values()):
        m.__dict__.pop("_captured_steps", None)
    _MESHES.clear()
    gc.collect()  # a captured step refers to its mesh: free the graphs now, not at exit
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
    dist.destroy_process_group()


@contextlib.contextmanager
def local_group(backend: str):
    """A process group of this process alone (world size 1) on a file store
    in a temporary directory, left through ``teardown`` on exit."""
    with tempfile.TemporaryDirectory() as d:
        init_distributed(f"file://{d}/store", 1, 0, backend=backend)
        try:
            yield
        finally:
            teardown()


def compute_device(device=None) -> torch.device:
    """The device this rank decodes on: ``device`` where given, else the
    rank's CUDA device (LOCAL_RANK, else the rank, modulo the cards of the
    host); without a CUDA device that raises (no fallback to the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("the sharded executors decode on a CUDA device and none is available; "
                           "pass device='cpu' to run the plain PyTorch versions on the CPU")
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed (or run under local_group) "
                           "first")
    world = dist.get_world_size()
    if torch.Size(shape).numel() != world:
        raise ValueError(f"a mesh spans every rank of the process group: {shape} over a world "
                         f"of {world}")
    dev = compute_device(device)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if device_type == "cuda":
        if dev.type != "cuda":
            raise ValueError(f"NCCL moves CUDA tensors; the compute device is {dev}")
        torch.cuda.set_device(dev)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def time_mesh(n_devices: int | None = None, *, device=None) -> DeviceMesh:
    """1-D mesh over time blocks (sequence-parallel streaming), one rank a
    block; ``device`` is the compute device (see ``compute_device``)."""
    return _mesh((n_devices or dist.get_world_size(),), ("time",), device)


def batch_mesh(n_devices: int | None = None, *, device=None) -> DeviceMesh:
    """1-D mesh over independent dwells or captures (data parallel)."""
    return _mesh((n_devices or dist.get_world_size(),), ("batch",), device)


def grid_mesh(n_time: int, n_batch: int, *, device=None) -> DeviceMesh:
    """2-D (batch, time) mesh: batches of captures, each time-sharded."""
    return _mesh((n_batch, n_time), ("batch", "time"), device)


def comm_device(mesh: DeviceMesh) -> torch.device:
    """The device of the mesh's collectives: the current CUDA device under
    NCCL, the CPU under gloo."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_batch(mesh: DeviceMesh, x, axis_name: str = "batch"):
    """This rank's rows of a leading-batch array (the reference's
    ``P(axis_name)`` placement); the rows must divide evenly."""
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not divide over the {n} ranks of {axis_name!r}")
    rows = x.shape[0] // n
    r = mesh.get_local_rank(axis_name)
    return x[r * rows : (r + 1) * rows]
