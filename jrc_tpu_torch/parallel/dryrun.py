"""The multi-rank dry run of the sharded executors (the port's twin of
``__graft_entry__.dryrun_multichip``): every rank of a process group runs one
step of each sharded path on the reference's tiny captures and checks what
it found.

    python -m jrc_tpu_torch.parallel.dryrun                    # one NCCL rank a card
    python -m jrc_tpu_torch.parallel.dryrun --world 4 --cpu    # four gloo ranks, CPU

The launcher starts ``--world`` rank processes (default: the host's cards,
as the reference's ``len(jax.devices())``) on a ``file://`` store in a
temporary directory: NCCL with one card a rank, or gloo decoding on the
CPU with ``--cpu``. It waits for them up to ``--timeout`` seconds; past it
every rank is killed and the dry run fails. Each rank (``dryrun``, in a
group that exists) checks, on the reference's captures:

- ``sharded_rx``: the QPSK-1/2 16-byte frame over 4096-sample blocks, one
  frame a block, every odd block's frame but the last's straddling into the
  next, ``max_frames_per_block=4``: frames == CRC-clean == world, each
  valid slot's payload the sent one;
- ``sharded_rx_dynamic`` on the same capture, ``max_payload=32``: frames ==
  CRC-clean == world;
- ``batched_rx`` over a batch mesh of the same ranks on the 2048 + halo
  captures, the frame at ``64 + 7·d`` in capture d, ``max_frames=2``:
  every row (1, 1);
- ``batched_range_angle_maps`` over the batch mesh: equal to
  ``radar.range_angle_map`` of the whole batch on this rank within
  1e-5 · max of the map;
- where a step is a captured CUDA graph (NCCL, ``streaming.captures``):
  each of the four equal in every field, bit for bit, to its run under
  ``graph.eager()``.

Every rank then leaves the group through ``mesh.teardown``, prints one
``DRYRUN_OK rank=... world=... ...`` line with its counts and exits 0; a
failed check raises. ``--out FILE`` has rank 0 write the gathered fields
(npz).
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

BLOCK_LEN = 4096
BATCH_LEN = 2048
MAX_PAYLOAD = 32


def frame(cfg):
    """(spec, payload, frame samples) of the reference's dry run: QPSK-1/2,
    16 bytes, through the channel at 0° with path loss 5 and no noise."""
    from jrc_tpu_torch import tables
    from jrc_tpu_torch.config import MCS, PacketType
    from jrc_tpu_torch.models import comm_link
    from jrc_tpu_torch.ops import channel
    from jrc_tpu_torch.ops.encoder import FrameSpec, make_payload

    spec = FrameSpec(MCS.QPSK_1_2, payload_bytes=16, packet_type=PacketType.DATA)
    payload = make_payload(spec, bytes([2]) + b"dryrun")
    tx = comm_link.tx_frame(cfg, spec, tables.from_numpy(cfg, spec, "cpu"),
                            torch.from_numpy(payload), 1)
    samples = channel.comm_channel(tx.samples, angle_deg=0.0, path_loss=5.0).numpy()
    return spec, payload, samples


def captures(cfg, world: int):
    """(spec, payload, capture (world·4096,), batch captures (world, 2048 +
    halo)) laid out as ``__graft_entry__.dryrun_multichip`` lays them out."""
    from jrc_tpu_torch.models import streaming

    spec, payload, f = frame(cfg)
    halo = streaming.frame_window_samples(cfg, spec) + cfg.fft_len
    if not BLOCK_LEN > max(halo, 2 * len(f)):
        raise ValueError(f"a {BLOCK_LEN}-sample block holds neither the halo nor two frames")
    rng = np.random.default_rng(0)
    cap = (rng.normal(0, 1e-4, (world * BLOCK_LEN, 2))
           .view(np.complex128)[:, 0]).astype(np.complex64)
    for d in range(world):
        if d % 2 == 1 and d < world - 1:  # its tail crosses into block d + 1
            pos = (d + 1) * BLOCK_LEN - len(f) // 3
        else:
            pos = d * BLOCK_LEN + (d * 977) % (BLOCK_LEN - len(f) - 8)
        cap[pos : pos + len(f)] += f
    caps = np.zeros((world, BATCH_LEN + halo), np.complex64)
    for d in range(world):
        caps[d, 64 + 7 * d : 64 + 7 * d + len(f)] = f
    return spec, payload, cap, caps


def channel_estimates(cfg, world: int) -> np.ndarray:
    """Two random (n_virt, fft_len) channel estimates a rank, from seed 5."""
    rng = np.random.default_rng(5)
    shape = (2 * world, cfg.n_virtual, cfg.fft_len)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dry run: {msg}")


def _leaves(res) -> list[torch.Tensor]:
    return [res] if isinstance(res, torch.Tensor) else list(res)


def dryrun(*, device=None, out: str | None = None) -> dict:
    """Every check of the module on this rank of the current process group
    (``device``: the compute device, see ``mesh.compute_device``) → its
    counts; raises on a failed check. Rank 0 writes the gathered fields to
    ``out`` (npz) where given."""
    import torch.distributed as dist

    from jrc_tpu_torch.config import OFDMConfig
    from jrc_tpu_torch.ops import radar
    from jrc_tpu_torch.parallel import batch, mesh, streaming
    from jrc_tpu_torch.utils import graph

    world = dist.get_world_size()
    cfg = OFDMConfig()
    spec, payload, cap, caps = captures(cfg, world)
    chans = channel_estimates(cfg, world)
    tm, bm = mesh.time_mesh(device=device), mesh.batch_mesh(device=device)
    block = streaming.local_block(tm, cap, device=device)
    captured = streaming.captures(tm, block)
    steps = {
        "sharded": lambda: streaming.sharded_rx(cfg, spec, tm, block, max_frames_per_block=4),
        "dynamic": lambda: streaming.sharded_rx_dynamic(cfg, tm, block, max_frames_per_block=4,
                                                        max_payload=MAX_PAYLOAD),
        "batched": lambda: batch.batched_rx(bm, cfg, spec, caps, max_frames=2, device=device),
        "maps": lambda: batch.batched_range_angle_maps(bm, chans, device=device),
    }
    got = {}
    for name, step in steps.items():
        got[name] = step()
        if captured:
            with graph.eager():
                want = step()
            for k, (a, b) in enumerate(zip(_leaves(got[name]), _leaves(want))):
                _check(torch.equal(a, b), f"{name}: field {k} of the captured step differs from "
                                          "its eager run")
    counts = {}
    for name in ("sharded", "dynamic"):
        res = got[name]
        n_frames, n_ok = int(res.n_frames), int(res.n_crc_ok)
        _check(n_frames == n_ok == world, f"{name}: {n_frames} frames, {n_ok} CRC-clean, "
                                          f"want {world}")
        counts[name] = (n_frames, n_ok)
    good = got["sharded"].payload[got["sharded"].valid].cpu().numpy()
    _check(bool((good == payload).all()), "sharded: a payload differs from the sent one")
    rows = got["batched"].cpu()
    _check(tuple(rows.shape) == (world, 2) and bool((rows == 1.0).all()),
           f"batched_rx: counts {rows.tolist()}, want (1, 1) a capture")
    h = torch.from_numpy(chans).to(block.device)
    whole = radar.range_angle_map(h)
    whole = (whole.real * whole.real + whole.imag * whole.imag).cpu()
    maps = got["maps"].cpu()
    err = float((maps - whole).abs().max())
    _check(maps.shape == whole.shape and err <= 1e-5 * float(whole.max()),
           f"batched_range_angle_maps: {err} from the whole batch's maps")
    if out and dist.get_rank() == 0:
        fields = {f"{name}_{k}": v.cpu().numpy() for name in ("sharded", "dynamic")
                  for k, v in got[name]._asdict().items()}
        np.savez(out, batched=rows.numpy(), maps=maps.numpy(), **fields)
    return dict(counts, batched=rows.int().tolist(), maps=tuple(maps.shape),
                maps_err=err, captured=captured)


def run_rank(store: str, world: int, rank: int, *, cpu: bool, out: str | None = None) -> None:
    """One rank: join the group at ``store``, run ``dryrun``, leave the group
    through ``mesh.teardown`` and print the ``DRYRUN_OK`` line."""
    import torch.distributed as dist

    from jrc_tpu_torch.parallel import mesh

    if cpu:
        torch.set_num_threads(1)  # the ranks share the host's cores
    mesh.init_distributed(store, world, rank, backend="gloo" if cpu else "nccl")
    try:
        backend = dist.get_backend()
        c = dryrun(device="cpu" if cpu else None, out=out)
    finally:
        mesh.teardown()
    batched = ";".join(",".join(map(str, row)) for row in c["batched"])
    print(f"DRYRUN_OK rank={rank} world={world} backend={backend} "
          f"frames={c['sharded'][0]} crc_ok={c['sharded'][1]} "
          f"dynamic_frames={c['dynamic'][0]} dynamic_crc_ok={c['dynamic'][1]} "
          f"batched={batched} maps={'x'.join(map(str, c['maps']))} maps_err={c['maps_err']:.3g} "
          f"captured={c['captured']}", flush=True)


def launch(world: int, *, cpu: bool, timeout: float, out: str | None = None) -> list[str]:
    """Start ``world`` ranks of this module and wait for them up to
    ``timeout`` seconds → each rank's output. Past the limit every rank is
    killed; a rank that was killed, exited non-zero or printed no
    ``DRYRUN_OK`` line fails the dry run (RuntimeError)."""
    from jrc_tpu_torch.parallel.launch import run_ranks

    with tempfile.TemporaryDirectory() as d:
        ranks = run_ranks(
            lambda r: [sys.executable, "-m", "jrc_tpu_torch.parallel.dryrun", "--store",
                       f"file://{d}/store", "--world", str(world), "--rank", str(r),
                       *(["--cpu"] if cpu else []), *(["--out", out] if out else [])],
            world, timeout=timeout, cwd=Path(__file__).resolve().parents[2],
            env_of=lambda r: {"OMP_NUM_THREADS": "1"})
    failed = []
    for r, (code, text) in enumerate(ranks):
        if code is None:
            failed.append(f"rank {r} still ran after {timeout:.0f} s and was killed:\n"
                          f"{text[-3000:]}")
        elif code != 0 or f"DRYRUN_OK rank={r} " not in text:
            failed.append(f"rank {r} exited {code}:\n{text[-3000:]}")
    if failed:
        raise RuntimeError("dry run failed: " + "\n".join(failed))
    return [text for _, text in ranks]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--world", type=int, default=None,
                   help="ranks to start (default: the host's cards)")
    p.add_argument("--cpu", action="store_true", help="gloo ranks decoding on the CPU")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds the launcher waits for every rank before it kills them")
    p.add_argument("--out", help="rank 0 writes the gathered fields here (npz)")
    p.add_argument("--store", help=argparse.SUPPRESS)  # set by the launcher in each rank
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        run_rank(args.store, args.world, args.rank, cpu=args.cpu, out=args.out)
        return 0
    world = args.world or torch.cuda.device_count()
    if world < 1:
        p.error("no CUDA device: pass --cpu and --world N to run gloo ranks on the CPU")
    if not args.cpu and world > torch.cuda.device_count():
        p.error(f"--world {world}: NCCL takes one card a rank and the host has "
                f"{torch.cuda.device_count()}")
    for text in launch(world, cpu=args.cpu, timeout=args.timeout, out=args.out):
        sys.stdout.write(text)
    print(f"dry run ok: {world} {'gloo' if args.cpu else 'NCCL'} ranks", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
